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
// What bounds it on this card: operations — M x N distance tests (1.3e8 at
// SA1, 9 f32 operations each: 0.018 ms at 67 TFLOP/s) against a few MB of
// bytes.  Stratified ranks need each ball's total before any slot is
// chosen, so the in-range bits of a whole scan must be kept.  Design: a
// block takes 32 centroids (4 per warp, their coordinates in registers) and
// streams the scene's keys through shared memory in 2,048-key tiles, so
// each key is read from L2 once per 32 centroids.  A warp turns each 32-key
// chunk into one ballot word per centroid; the words of all 32 centroids
// over all N keys stay in shared memory (102 KB at N = 25,600; 160 bytes
// per 32 keys with the prefix counts, so N <= 41,568 — the launcher
// returns cudaErrorInvalidValue beyond).  Then each warp, per centroid, takes the words' prefix counts
// and walks the ranks with slab_select.cuh, the selection K2 and K3 use.

#include "slab_select.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kPerWarp = 4;
constexpr int kCentroidsPerBlock = kWarps * kPerWarp;
constexpr int kKeyTile = 2048;
constexpr size_t kTileBytes = 3 * sizeof(float) * kKeyTile;

__global__ void __launch_bounds__(kWarps * 32)
ball_query_full_kernel(const float* __restrict__ pts,
                       const float* __restrict__ cents, int n, int m,
                       int nwords, float r2, int k, int stratified,
                       int* __restrict__ idx, int* __restrict__ cnt) {
  extern __shared__ float smem[];
  float* kx = smem;
  float* ky = kx + kKeyTile;
  float* kz = ky + kKeyTile;
  unsigned* words_all = reinterpret_cast<unsigned*>(kz + kKeyTile);
  int* prefix_all =
      reinterpret_cast<int*>(words_all + kCentroidsPerBlock * nwords);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCentroidsPerBlock + (threadIdx.x / 32) *
                                                       kPerWarp;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
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

// pts (B, 3, N), cents (B, 3, M) f32; idx (B, M, K), cnt (B, M) int32.
extern "C" int s4g_ball_query_full(const float* pts, const float* cents,
                                   int b, int n, int m, float r2, int k,
                                   int stratified, int* idx, int* cnt,
                                   cudaStream_t stream) {
  if (n < 1 || m < 1 || k < 1) return cudaErrorInvalidValue;
  const int nwords = (n + 31) / 32;
  const size_t smem =
      kTileBytes + (kCentroidsPerBlock + kWarps) * sizeof(int) *
                       static_cast<size_t>(nwords);
  if (smem > kS4gMaxSmem) return cudaErrorInvalidValue;  // N > 41,568
  static size_t granted = 0;
  cudaError_t err = s4g_allow_smem(ball_query_full_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kCentroidsPerBlock - 1) / kCentroidsPerBlock, b);
  ball_query_full_kernel<<<grid, kWarps * 32, smem, stream>>>(
      pts, cents, n, m, nwords, r2, k, stratified, idx, cnt);
  return cudaGetLastError();
}
