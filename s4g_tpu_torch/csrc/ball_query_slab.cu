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
// What bounds it on this card: operations — every centroid tests all 8,192
// keys of its window (~42 M distance tests at SA1) while the bytes are a
// few MB.  Design: a block takes 32 centroids of one tile and stages the
// tile's key window in shared memory once (96 KB), so the keys come from
// HBM/L2 once per block, not once per centroid.  One warp per centroid:
// pass 1 turns each 32-key chunk into one ballot word (256 words, kept in
// shared memory, so distances are computed once); a warp scan gives the
// words' prefix counts; each lane then finds its slots' target ranks by
// binary search over the prefixes and a bit walk inside one word.

#include "common.cuh"

namespace {

constexpr int kCentroidTile = 512;    // BQ_C_TILE
constexpr int kKeyTile = 2048;        // BQ_K_TILE
constexpr int kWindow = 4 * kKeyTile; // BQ_SLAB_TILES * BQ_K_TILE keys
constexpr int kWords = kWindow / 32;
constexpr int kWarps = 8;
constexpr int kCentroidsPerBlock = 32;
static_assert(kCentroidTile % kCentroidsPerBlock == 0,
              "a block must not straddle two centroid tiles");
static_assert(kWords == 32 * 8, "the word scan gives each lane 8 words");

constexpr size_t kSmemBytes =
    3 * sizeof(float) * kWindow + 2 * sizeof(unsigned) * kWarps * kWords;

__global__ void __launch_bounds__(kWarps * 32)
ball_query_slab_kernel(const float* __restrict__ pts,
                       const float* __restrict__ cents,
                       const int* __restrict__ lo_tile, int n, int m,
                       int ntile, float r2, int k, int stratified,
                       int* __restrict__ idx, int* __restrict__ cnt) {
  extern __shared__ float smem[];
  float* kx = smem;
  float* ky = kx + kWindow;
  float* kz = ky + kWindow;
  unsigned* words_all = reinterpret_cast<unsigned*>(kz + kWindow);
  int* prefix_all = reinterpret_cast<int*>(words_all + kWarps * kWords);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCentroidsPerBlock;
  const int base = lo_tile[b * ntile + c0 / kCentroidTile] * kKeyTile;
  const float* P = pts + static_cast<size_t>(b) * 3 * n;
  for (int j = threadIdx.x; j < kWindow; j += blockDim.x) {
    const int g = base + j;
    const bool real = g < n;  // keys past N are padding, never in range
    kx[j] = real ? P[g] : 1e9f;
    ky[j] = real ? P[n + g] : 1e9f;
    kz[j] = real ? P[2 * n + g] : 1e9f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned* words = words_all + warp * kWords;
  int* prefix = prefix_all + warp * kWords;
  const float* C = cents + static_cast<size_t>(b) * 3 * m;
  const int c_end = min(c0 + kCentroidsPerBlock, m);

  for (int c = c0 + warp; c < c_end; c += kWarps) {
    const float cx = C[c], cy = C[m + c], cz = C[2 * m + c];

    // Pass 1: one in-range ballot word per 32-key chunk.
    for (int w = 0; w < kWords; ++w) {
      const int j = w * 32 + lane;
      const float d = s4g_sqdist(kx[j], ky[j], kz[j], cx, cy, cz);
      const unsigned bits = __ballot_sync(S4G_FULL_MASK, d < r2);
      if (lane == 0) words[w] = bits;
    }
    __syncwarp();

    // Inclusive prefix counts of the words: 8 words per lane + warp scan.
    int local[8];
    int run = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      run += __popc(words[lane * 8 + q]);
      local[q] = run;
    }
    int incl = run;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(S4G_FULL_MASK, incl, o);
      if (lane >= o) incl += t;
    }
    const int excl = incl - run;
#pragma unroll
    for (int q = 0; q < 8; ++q) prefix[lane * 8 + q] = excl + local[q];
    const int total = __shfl_sync(S4G_FULL_MASK, incl, 31);
    __syncwarp();

    // Pass 2: slot -> target rank -> (word, bit) -> key index.
    const int count = min(total, k);
    int* out = idx + (static_cast<size_t>(b) * m + c) * k;
    int first = 0;
    for (int s0 = 0; s0 < k; s0 += 32) {
      const int slot = s0 + lane;
      int v = 0;
      if (slot < count) {
        const int target = (stratified && total > k)
                               ? (slot * total) / k + 1
                               : slot + 1;
        int lo = 0, hi = kWords - 1;  // first word whose prefix >= target
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (prefix[mid] >= target) hi = mid; else lo = mid + 1;
        }
        int rank = target - (lo > 0 ? prefix[lo - 1] : 0);
        unsigned word = words[lo];
        while (--rank > 0) word &= word - 1;  // drop the lower set bits
        v = base + lo * 32 + (__ffs(word) - 1);
      }
      if (s0 == 0) first = __shfl_sync(S4G_FULL_MASK, v, 0);
      if (slot < k) out[slot] = slot < count ? v : first;
    }
    if (lane == 0) cnt[static_cast<size_t>(b) * m + c] = count;
    __syncwarp();
  }
}

}  // namespace

extern "C" int s4g_ball_query_slab(const float* pts, const float* cents,
                                   const int* lo_tile, int b, int n, int m,
                                   int ntile, float r2, int k, int stratified,
                                   int* idx, int* cnt, cudaStream_t stream) {
  static size_t granted = 0;
  cudaError_t err =
      s4g_allow_smem(ball_query_slab_kernel, kSmemBytes, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kCentroidsPerBlock - 1) / kCentroidsPerBlock, b);
  ball_query_slab_kernel<<<grid, kWarps * 32, kSmemBytes, stream>>>(
      pts, cents, lo_tile, n, m, ntile, r2, k, stratified, idx, cnt);
  return cudaGetLastError();
}
