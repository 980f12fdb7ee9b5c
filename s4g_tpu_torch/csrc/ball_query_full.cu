// Full-scan ball query (K2f).
//
// Replaces the TPU kernel s4g_tpu/ops/pallas/neighbor_kernels.py::
// _bq_fused_kernel as driven by ball_query_fused_pallas (pallas_call at
// neighbor_kernels.py:343): every centroid tests every key of its scene.
// A key is in range when its f32 difference-form squared distance is < r2
// (strict).  Slot s takes the in-range key of scan rank s+1, or, with
// `stratified` and an overfull ball (total > K), of rank
// floor(s*total/K)+1.  count = min(total, K); unfilled slots repeat slot 0;
// with no hit every slot is 0.
//
// What bounds it on this card: operations — M x N distance tests, 9 f32
// operations each (1.3e8 at the parity path's SA1: 0.018 ms at 67
// TFLOP/s), against a few MB of bytes; on keys that ascend along a
// coordinate only the tests of each ball's slab are needed.
// Design, for Hopper: one launch, one of two kernels.
// * The warp kernel (every call but the one below): a warp takes one
//   centroid at a time and reads the keys straight from L2 (12 bytes a
//   key, coalesced; the block's warps share them through L1), with no
//   block barrier in the scan, so the launcher sizes blocks from M and the
//   card: the most centroids per block (up to 32) that still give at least
//   one block per SM (SA2 at b = 1: 4 a block, 256 blocks; SA3: 1, 256
//   blocks).
//   - Handed the promise of keys that ascend (`axes`, each scene's sort
//     axis, or NULL), every block checks on the card that its scene's key
//     coordinate ascends (one pass over N floats, float4 where it can)
//     before it trusts it.  Then each centroid scans only the ballot words
//     that hold the keys within slab_select.cuh's `margin` of it along that
//     axis, found by `bound`; every other key is out of range, so the
//     ranks are the full scan's.  A scene that breaks the promise is
//     scanned in full.
//   - That check costs every block a pass over the scene, so the promise is
//     used only where a ball's slab (2 x margin) spans at most a third
//     (1 / kSlabShare) of the scene's extent along the axis (last key minus
//     first): on a ~1.1 m tabletop SA1's fallback (slab ~4 % of it) and SA2
//     (~15 %) take it, SA3 (r = 0.32, ~60 %) is scanned in full, which on
//     an H100 was faster there than the check plus its slab.
//   - A warp keeps the ballot words of its scan and their prefix counts in
//     shared memory, up to kCapWords words (32,768 keys, 8 KB a warp).  A
//     longer scan (N past 32,768 keys, or a slab that wide) runs in
//     segments of kCapWords words: one pass counts the total (the
//     stratified ranks need it first), a second rebuilds each segment's
//     words and resolves the slots whose ranks fall in it.  So any N runs,
//     with no scratch in device memory.
// * The tile kernel, for a call without a promise whose M fills the card
//   at 32 centroids a block and whose N fits its shared memory (the
//   parity path's SA1; detect_batch's SA1 fallback has the promise): a
//   block takes 32 centroids (4 per warp, in registers) and streams the
//   scene's keys through shared memory in 2,048-key tiles, so each key
//   load from shared memory feeds four distance tests; the ballot words of
//   all 32 centroids over all N keys stay in shared memory (160 bytes per
//   32 keys with the prefix counts: N <= 41,568).  On such scans it beat
//   the warp kernel when the two were timed side by side on an H100.

#include <stdint.h>

#include "slab_select.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxPerBlock = 32;
constexpr int kCapWords = 1024;
constexpr float kSlabShare = 3.0f;

// One warp: the ballot words [w_lo, w_lo + nw) of centroid (cx, cy, cz)
// over the scene's keys P (SoA, N of each coordinate) into words[0, nw),
// their inclusive prefix counts into prefix[0, nw).  Returns their total.
// Lane i keeps word w0 + i of each run of 32 in a register and stores it
// after the run, as slab_select.cuh's scan_words does.
__device__ __forceinline__ int scan_keys(const float* __restrict__ P, int n,
                                         float cx, float cy, float cz,
                                         float r2, unsigned* words,
                                         int* prefix, int w_lo, int nw,
                                         int lane) {
  for (int w0 = 0; w0 < nw; w0 += 32) {
    const int len = min(32, nw - w0);
    unsigned mine = 0;
#pragma unroll 4
    for (int i = 0; i < len; ++i) {
      const int j = (w_lo + w0 + i) * 32 + lane;
      bool in = false;
      if (j < n)  // keys past N are never in range
        in = s4g_sqdist(__ldg(P + j), __ldg(P + n + j), __ldg(P + 2 * n + j),
                        cx, cy, cz) < r2;
      const unsigned bits = __ballot_sync(S4G_FULL_MASK, in);
      mine = lane == i ? bits : mine;
    }
    if (lane < len) words[w0 + lane] = mine;
  }
  __syncwarp();
  return s4g_slab::prefix_counts(words, prefix, nw, lane);
}

// Does ka[0, n) ascend (no NaN)?  Every thread of the block takes part.
__device__ __forceinline__ bool ascends(const float* __restrict__ ka, int n) {
  bool ok = true;
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(ka) % 16 == 0) {
    const float4* k4 = reinterpret_cast<const float4*>(ka);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
      const float4 v = __ldg(k4 + i);
      ok &= v.x <= v.y && v.y <= v.z && v.z <= v.w;
      if (4 * i + 4 < n) ok &= v.w <= __ldg(ka + 4 * i + 4);
    }
  } else {
    for (int j = threadIdx.x; j + 1 < n; j += blockDim.x)
      ok &= __ldg(ka + j) <= __ldg(ka + j + 1);
  }
  return __syncthreads_and(ok) != 0;
}

// One warp, one centroid, its ballot words [w_lo, w_lo + nw): the count
// and the K slots, written to out[0, k) and *cnt_out.
__device__ __forceinline__ void select_slots(
    const float* __restrict__ P, int n, float cx, float cy, float cz,
    float r2, int k, int stratified, unsigned* words, int* prefix, int cap,
    int w_lo, int nw, int* __restrict__ out, int* cnt_out, int lane) {
  int total = 0;
  if (nw <= cap) {
    total = scan_keys(P, n, cx, cy, cz, r2, words, prefix, w_lo, nw, lane);
  } else {  // count first; each segment's words are rebuilt below
    for (int s = 0; s < nw; s += cap) {
      total += scan_keys(P, n, cx, cy, cz, r2, words, prefix, w_lo + s,
                         min(cap, nw - s), lane);
      __syncwarp();
    }
  }
  const int count = min(total, k);
  int first = 0;  // slot 0's key, on lane 0
  int base = 0;   // in-range keys before the segment
  // The segments up to the last slot's rank.
  const int need =
      count > 0 ? s4g_slab::slot_target(count - 1, total, k, stratified) : 0;
  for (int s = 0; s < nw && base < need; s += cap) {
    const int len = min(cap, nw - s);
    const int seg = nw <= cap ? total
                              : scan_keys(P, n, cx, cy, cz, r2, words,
                                          prefix, w_lo + s, len, lane);
    for (int s0 = 0; s0 < count; s0 += 32) {
      const int slot = s0 + lane;
      if (slot >= count) continue;
      const int t = s4g_slab::slot_target(slot, total, k, stratified);
      if (t <= base || t > base + seg) continue;
      const int v = (w_lo + s) * 32 +
                    s4g_slab::rank_to_local(words, prefix, t - base, len);
      out[slot] = v;
      if (slot == 0) first = v;
    }
    base += seg;
    __syncwarp();  // the words are rewritten for the next segment
  }
  first = __shfl_sync(S4G_FULL_MASK, first, 0);
  for (int slot = count + lane; slot < k; slot += 32) out[slot] = first;
  if (lane == 0) *cnt_out = count;
  __syncwarp();  // the words are rewritten for the next centroid
}

__global__ void __launch_bounds__(kMaxWarps * 32)
warp_kernel(const float* __restrict__ pts, const float* __restrict__ cents,
            const int* __restrict__ axes, int n, int m, int per_block,
            int cap, float r2, int k, int stratified, int* __restrict__ idx,
            int* __restrict__ cnt) {
  extern __shared__ unsigned smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const float* P = pts + static_cast<size_t>(b) * 3 * n;
  const float* C = cents + static_cast<size_t>(b) * 3 * m;
  unsigned* words = smem + warp * 2 * cap;
  int* prefix = reinterpret_cast<int*>(words + cap);

  // The promise is used where a ball's slab is a small share of the scene
  // along its axis, and checked here before it is; a scene whose key
  // coordinate does not ascend is scanned in full.  The axis and every
  // coordinate's extent are loaded together (one load's latency, not
  // two); every thread of the block reads the same keys, so all or none
  // of them take the check.
  int axis = -1;
  if (axes != nullptr) {
    const int a = __ldg(axes + b);
    float extent[3];
#pragma unroll
    for (int q = 0; q < 3; ++q)
      extent[q] = __ldg(P + static_cast<size_t>(q) * n + n - 1) -
                  __ldg(P + static_cast<size_t>(q) * n);
    if (0 <= a && a < 3 &&
        2.0f * kSlabShare * s4g_slab::margin(r2, 0.0f) <=
            (a == 0 ? extent[0] : a == 1 ? extent[1] : extent[2]) &&
        ascends(P + static_cast<size_t>(a) * n, n))
      axis = a;
  }
  const float* ka = P + static_cast<size_t>(axis < 0 ? 0 : axis) * n;
  const int nwords = (n + 31) / 32;

  const int c_end = min(m, (blockIdx.x + 1) * per_block);
  for (int c = blockIdx.x * per_block + warp; c < c_end; c += warps) {
    const float cx = C[c], cy = C[m + c], cz = C[2 * m + c];
    int w_lo = 0, w_hi = nwords;
    if (axis >= 0) {
      const float ca = axis == 0 ? cx : axis == 1 ? cy : cz;
      const float mg = s4g_slab::margin(r2, ca);
      w_lo = s4g_slab::bound(ka, n, ca - mg, false, lane) / 32;
      w_hi = (s4g_slab::bound(ka, n, ca + mg, true, lane) + 31) / 32;
      w_hi = max(w_hi, w_lo);
    }
    select_slots(P, n, cx, cy, cz, r2, k, stratified, words, prefix, cap,
                 w_lo, w_hi - w_lo,
                 idx + (static_cast<size_t>(b) * m + c) * k,
                 cnt + static_cast<size_t>(b) * m + c, lane);
  }
}

// The tile kernel: 32 centroids a block, 4 a warp.
constexpr int kTileWarps = 8;
constexpr int kPerWarp = 4;
constexpr int kTileCentroids = kTileWarps * kPerWarp;
constexpr int kKeyTile = 2048;
constexpr size_t kTileBytes = 3 * sizeof(float) * kKeyTile;
static_assert(kTileCentroids == kMaxPerBlock, "one block geometry");

__global__ void __launch_bounds__(kTileWarps * 32)
tile_kernel(const float* __restrict__ pts, const float* __restrict__ cents,
            int n, int m, int nwords, float r2, int k, int stratified,
            int* __restrict__ idx, int* __restrict__ cnt) {
  extern __shared__ float tsmem[];
  float* kx = tsmem;
  float* ky = kx + kKeyTile;
  float* kz = ky + kKeyTile;
  unsigned* words_all = reinterpret_cast<unsigned*>(kz + kKeyTile);
  int* prefix_all =
      reinterpret_cast<int*>(words_all + kTileCentroids * nwords);

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * kTileCentroids + warp * kPerWarp;
  const float* P = pts + static_cast<size_t>(b) * 3 * n;
  const float* C = cents + static_cast<size_t>(b) * 3 * m;

  // This warp's centroids c0 .. c0 + 3 (past M: a copy of the last one,
  // scanned but never written).
  float cx[kPerWarp], cy[kPerWarp], cz[kPerWarp];
#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) {
    const int c = min(c0 + q, m - 1);
    cx[q] = C[c];
    cy[q] = C[m + c];
    cz[q] = C[2 * m + c];
  }
  unsigned* words = words_all + warp * kPerWarp * nwords;

  for (int base = 0; base < n; base += kKeyTile) {
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < kKeyTile; j += blockDim.x) {
      const int g = min(base + j, n - 1);
      kx[j] = P[g];
      ky[j] = P[n + g];
      kz[j] = P[2 * n + g];
    }
    __syncthreads();
    const int keys = min(kKeyTile, n - base);
    for (int w = 0; w < (keys + 31) / 32; ++w) {
      const int j = w * 32 + lane;
      const bool real = j < keys;  // keys past N are never in range
      unsigned bits[kPerWarp];
#pragma unroll
      for (int q = 0; q < kPerWarp; ++q) {
        const float d = s4g_sqdist(kx[j], ky[j], kz[j], cx[q], cy[q], cz[q]);
        bits[q] = __ballot_sync(S4G_FULL_MASK, real && d < r2);
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kPerWarp; ++q)
          words[q * nwords + base / 32 + w] = bits[q];
      }
    }
  }
  __syncwarp();  // a warp reads only the words its own lane 0 wrote

  int* prefix = prefix_all + warp * nwords;
  for (int q = 0; q < kPerWarp && c0 + q < m; ++q) {
    const int c = c0 + q;
    const unsigned* cw = words + q * nwords;
    const int total = s4g_slab::prefix_counts(cw, prefix, nwords, lane);
    const int count = min(total, k);
    int* out = idx + (static_cast<size_t>(b) * m + c) * k;
    int first = 0;
    for (int s0 = 0; s0 < k; s0 += 32) {
      const int slot = s0 + lane;
      int v = 0;
      if (slot < count) {
        v = s4g_slab::rank_to_local(
            cw, prefix, s4g_slab::slot_target(slot, total, k, stratified),
            nwords);
      }
      if (s0 == 0) first = __shfl_sync(S4G_FULL_MASK, v, 0);
      if (slot < k) out[slot] = slot < count ? v : first;
    }
    if (lane == 0) cnt[static_cast<size_t>(b) * m + c] = count;
    __syncwarp();  // the prefix buffer is rewritten for the next centroid
  }
}

}  // namespace

// pts (B, 3, N), cents (B, 3, M) f32; axes (B,) int32 or NULL: each scene's
// promised sort axis; idx (B, M, K), cnt (B, M) int32.
extern "C" int s4g_ball_query_full(const float* pts, const float* cents,
                                   const int* axes, int b, int n, int m,
                                   float r2, int k, int stratified, int* idx,
                                   int* cnt, cudaStream_t stream) {
  if (b < 1 || n < 1 || m < 1 || k < 1) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = s4g_sm_count(&sms);
  if (err != cudaSuccess) return err;
  // The most centroids per block that still give every SM a block.
  int per_block = kMaxPerBlock;
  while (per_block > 1 &&
         static_cast<long long>(b) * ((m + per_block - 1) / per_block) < sms)
    per_block /= 2;
  const int nwords = (n + 31) / 32;
  const dim3 grid((m + per_block - 1) / per_block, b);
  const size_t tile_smem =
      kTileBytes + (kTileCentroids + kTileWarps) * sizeof(int) *
                       static_cast<size_t>(nwords);
  if (axes == nullptr && per_block == kMaxPerBlock &&
      tile_smem <= kS4gMaxSmem) {
    static size_t granted = 0;
    err = s4g_allow_smem(tile_kernel, tile_smem, &granted);
    if (err != cudaSuccess) return err;
    tile_kernel<<<grid, kTileWarps * 32, tile_smem, stream>>>(
        pts, cents, n, m, nwords, r2, k, stratified, idx, cnt);
    return cudaGetLastError();
  }
  const int warps = per_block < kMaxWarps ? per_block : kMaxWarps;
  const int cap = nwords < kCapWords ? nwords : kCapWords;
  const size_t smem = static_cast<size_t>(warps) * 2 * cap * sizeof(int);
  static size_t granted = 0;
  err = s4g_allow_smem(warp_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  warp_kernel<<<grid, warps * 32, smem, stream>>>(
      pts, cents, axes, n, m, per_block, cap, r2, k, stratified, idx, cnt);
  return cudaGetLastError();
}
