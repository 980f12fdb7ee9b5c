// Sorted-slab ball query (K2).
//
// Replaces the TPU kernel s4g_tpu/ops/pallas/neighbor_kernels.py::
// _bq_fused_kernel as driven by ball_query_fused_slab_pallas (pallas_call at
// neighbor_kernels.py:484).  Points and centroids of a scene are sorted
// along the same axis.  Centroid tile t (512 centroids) scans only the
// 8,192-key window that starts at key lo_tile[b, t] * 2048.  A key is in
// range when its f32 difference-form squared distance is < r2 (strict).
// Slot s takes the in-range key of scan rank s+1, or, with `stratified` and
// an overfull ball (total > K), of rank floor(s*total/K)+1.  count =
// min(total, K); unfilled slots repeat slot 0; with no hit every slot is 0.
// Indices point into the sorted order.
//
// What bounds it on this card: operations — the distance tests (the data
// needs ~5 M of the windows' ~42 M at SA1: only the keys of each ball's
// slab along the sort axis can be in range), while the bytes are a few MB.
// Design: a block takes 8 consecutive centroids of one tile, one warp each,
// so a b = 1 call puts ~5 blocks on every SM (8 beat 4, 16 and 32 on the
// card at SA1's shape).
// * Check on the card, then restrict: the block finds a coordinate that
//   ascends over the whole window (read from L2 2,048 keys a round,
//   stopping at the first round that does not ascend; the coordinate along
//   which the block's centroids ascend is tried first, so a sorted scene's
//   window is read once), keeping every 32nd key (the word heads) in shared
//   memory.  Along it, each warp bounds its ball's slab (`margin`, `bound`
//   over the heads) and scans only the ballot words that hold it; every
//   other key of the window is out of range, so ranks, totals and slots are
//   the full window's.  Where no coordinate ascends, every warp scans the
//   whole window: a broken promise costs time, never a wrong answer.  (A
//   check shared by a thread-block cluster over DSMEM read less from L2 but
//   ran slower on the card: its cluster barriers cost more than the loads.)
// * Stage less: the block's slabs are one key range (the union), staged in
//   shared memory 2,048 keys at a time (24 KB; one chunk at SA1), not the
//   whole 96 KB window.  Each warp turns the chunk's part of its slab into
//   ballot words; after the last chunk a warp scan gives the words' prefix
//   counts, and each lane finds its slots' keys by binary search over the
//   prefixes and a bit walk inside one word.  The ballot words, their
//   prefixes, the rank walk and the slab bounds live in slab_select.cuh,
//   shared with K3 and K2f.

#include "slab_select.cuh"

namespace {

using s4g_slab::kCentroidTile;
using s4g_slab::kKeyTile;
using s4g_slab::kWindow;
using s4g_slab::kWords;
constexpr int kStageKeys = 2048;             // keys staged per chunk
constexpr int kStageWords = kStageKeys / 32;
constexpr int kWarps = 8;                    // centroids per block
constexpr int kThreads = kWarps * 32;
static_assert(kCentroidTile % kWarps == 0,
              "a block must not straddle two centroid tiles");
constexpr size_t kSmemBytes =
    3 * sizeof(float) * kStageKeys + 2 * sizeof(unsigned) * kWarps * kWords;

// Does the coordinate row ka[0, kWindow) ascend (keys from n_real on are
// padding, 1e9; a NaN fails)?  Every thread of the block takes part, 2,048
// keys a round (each thread issues all its loads of the round, then
// compares); the check stops at the first round that does not ascend.
// Fills heads[w] with key 32 w, for the slab bounds.
__device__ __forceinline__ bool window_ascends(const float* __restrict__ ka,
                                               int n_real, float* heads) {
  constexpr int kPer = kStageKeys / kThreads;
  for (int c0 = 0; c0 < kWindow; c0 += kStageKeys) {
    float a[kPer], next[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = c0 + threadIdx.x + u * kThreads;
      a[u] = j < n_real ? __ldg(ka + j) : 1e9f;
      next[u] = j + 1 < n_real ? __ldg(ka + j + 1) : 1e9f;
    }
    int up = 1;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = c0 + threadIdx.x + u * kThreads;
      if (j + 1 < kWindow) up &= a[u] <= next[u];
      if (j % 32 == 0) heads[j / 32] = a[u];
    }
    if (!__syncthreads_and(up)) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
ball_query_slab_kernel(const float* __restrict__ pts,
                       const float* __restrict__ cents,
                       const int* __restrict__ lo_tile, int n, int m,
                       int ntile, float r2, int k, int stratified,
                       int* __restrict__ idx, int* __restrict__ cnt) {
  extern __shared__ float smem[];
  __shared__ float heads[kWords];   // key 32 w of the ascending coordinate
  __shared__ int range[2];          // the block's slab words [range[0], range[1])
  __shared__ int centroids_ascend;  // bit a: the block's centroids ascend
  float* sx = smem;
  float* sy = sx + kStageKeys;
  float* sz = sy + kStageKeys;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned* words_all = reinterpret_cast<unsigned*>(sz + kStageKeys);
  int* prefix_all = reinterpret_cast<int*>(words_all + kWarps * kWords);
  unsigned* words = words_all + warp * kWords;
  int* prefix = prefix_all + warp * kWords;

  const int b = blockIdx.y;
  const int c = blockIdx.x * kWarps + warp;
  const bool live = c < m;   // uniform over the warp
  const float* C = cents + static_cast<size_t>(b) * 3 * m;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (live) {
    cx = C[c];
    cy = C[m + c];
    cz = C[2 * m + c];
  }
  const int base =
      lo_tile[b * ntile + blockIdx.x * kWarps / kCentroidTile] * kKeyTile;
  const int n_real = max(0, min(kWindow, n - base));
  const float* P = pts + static_cast<size_t>(b) * 3 * n;

  // Check first the coordinate along which the block's centroids ascend:
  // on a sorted scene it is the sort axis, so the window is read once.  Any
  // coordinate that ascends over the window gives the same selection.
  if (threadIdx.x == 0) centroids_ascend = 7;
  __syncthreads();
  if (lane == 0 && warp + 1 < kWarps && c + 1 < m)
    atomicAnd(&centroids_ascend, (cx <= C[c + 1] ? 1 : 0) |
                                     (cy <= C[m + c + 1] ? 2 : 0) |
                                     (cz <= C[2 * m + c + 1] ? 4 : 0));
  __syncthreads();
  const int guess = centroids_ascend ? __ffs(centroids_ascend) - 1 : 0;
  int axis = -1;
  for (int q = 0; q < 3 && axis < 0; ++q) {
    const int a = (guess + q) % 3;
    if (window_ascends(P + static_cast<size_t>(a) * n + base, n_real, heads))
      axis = a;
  }

  int w_lo = 0, nw = kWords;
  if (threadIdx.x == 0) {
    range[0] = axis >= 0 ? kWords : 0;
    range[1] = axis >= 0 ? 0 : kWords;
  }
  __syncthreads();
  if (axis >= 0 && live) {
    // The slab's words, from the word heads: the words before the last
    // head below ca - mg hold keys below it only, the words from the first
    // head above ca + mg on keys above it only.
    const float ca = axis == 0 ? cx : axis == 1 ? cy : cz;
    const float mg = s4g_slab::margin(r2, ca);
    w_lo = max(0, s4g_slab::bound(heads, kWords, ca - mg, false, lane) - 1);
    nw = s4g_slab::bound(heads, kWords, ca + mg, true, lane) - w_lo;
    if (lane == 0 && nw > 0) {
      atomicMin(&range[0], w_lo);
      atomicMax(&range[1], w_lo + nw);
    }
  }
  __syncthreads();

  // Stage the union of the slabs chunk by chunk; each warp ballots the
  // chunk's words of its own slab.
  const int r_hi = range[1];
  for (int w0 = range[0]; w0 < r_hi; w0 += kStageWords) {
    const int w1 = min(r_hi, w0 + kStageWords);
    for (int j = threadIdx.x; j < (w1 - w0) * 32; j += kThreads) {
      const int g = base + w0 * 32 + j;
      const bool real = g < n;   // keys past N are padding, never in range
      sx[j] = real ? P[g] : 1e9f;
      sy[j] = real ? P[n + g] : 1e9f;
      sz[j] = real ? P[2 * n + g] : 1e9f;
    }
    __syncthreads();
    const int a = max(w_lo, w0), e = min(w_lo + nw, w1);
    if (live && a < e)
      s4g_slab::ballot_words(sx, sy, sz, cx, cy, cz, r2, words + (a - w_lo),
                             a - w0, e - a, lane);
    __syncthreads();
  }
  if (!live) return;

  // Slot -> target rank -> (word, bit) -> key index.
  const int total = s4g_slab::prefix_counts(words, prefix, nw, lane);
  const int count = min(total, k);
  int* out = idx + (static_cast<size_t>(b) * m + c) * k;
  int first = 0;
  for (int s0 = 0; s0 < k; s0 += 32) {
    const int slot = s0 + lane;
    int v = 0;
    if (slot < count) {
      v = base + w_lo * 32 +
          s4g_slab::rank_to_local(
              words, prefix,
              s4g_slab::slot_target(slot, total, k, stratified), nw);
    }
    if (s0 == 0) first = __shfl_sync(S4G_FULL_MASK, v, 0);
    if (slot < k) out[slot] = slot < count ? v : first;
  }
  if (lane == 0) cnt[static_cast<size_t>(b) * m + c] = count;
}

}  // namespace

// pts (B, 3, N), cents (B, 3, M) f32; lo_tile (B, ntile) int32.
extern "C" int s4g_ball_query_slab(const float* pts, const float* cents,
                                   const int* lo_tile, int b, int n, int m,
                                   int ntile, float r2, int k, int stratified,
                                   int* idx, int* cnt, cudaStream_t stream) {
  if (b < 1 || m < 1 || k < 1) return cudaErrorInvalidValue;
  const dim3 grid((m + kWarps - 1) / kWarps, b);
  ball_query_slab_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      pts, cents, lo_tile, n, m, ntile, r2, k, stratified, idx, cnt);
  return cudaGetLastError();
}
