// Fused set-abstraction stage 1 (K3): slab ball query + grouping + the
// stage's 3-layer BN-folded MLP + max over the K neighbours, in one kernel.
//
// Replaces the TPU kernel s4g_tpu/ops/pallas/sa_fused_kernels.py::
// _sa1_kernel as driven by sa1_fused_slab_pallas (pallas_call at
// sa_fused_kernels.py:423).  Per centroid:
// * selection exactly as K2 (slab_select.cuh): the 8,192-key window of the
//   centroid's 512-tile, strict f32 difference-form d2 < r2, stratified
//   ranks for overfull balls, unfilled slots repeat slot 0;
// * rel = key - centroid in exact f32, then rounded to bf16;
// * layer 1: ((rx*w0 + ry*w1) + rz*w2) + b1 in f32 with bf16-rounded
//   weights, ReLU, -> bf16;
// * layers 2 and 3: bf16 x bf16 products with f32 sums (tensor cores,
//   mma.sync m16n8k16), + bias, ReLU; layer 2's output -> bf16, layer 3's
//   stays f32;
// * max over the K slots; a centroid with no key in range writes zeros.
// Output (B, M, C3) f32.  The kernel holds C1 = C2 = 128 and C3 a multiple
// of 64 up to 256 (curvature_model.yaml's SA1 is 128/128/256) and K <= 128.
//
// What bounds it on this card: operations — at SA1 (M = 5,120, K = 64,
// 128/128/256) a scene needs ~32 GFLOP of bf16 products in layers 2-3
// (~33 us at 989 TFLOP/s) plus ~0.6 G f32 operations for the distance
// masks and layer 1 (~9 us at 67 TFLOP/s), against ~5 MB of traffic.
// Design: a block takes 32 centroids of one tile.  Phase 1 stages the key
// window in shared memory (96 KB) and one warp per centroid selects its
// slots and keeps only their bf16-rounded rel (32 x K x 3 floats).  The
// window is then dead, so phase 2 reuses its shared memory for W2 and W3
// in bf16, transposed (n-major, rows padded so that B-fragment loads are
// free of bank conflicts).  One warp per centroid runs the chain 16 slots
// at a time: layer 1 is computed straight into mma A fragments, layer 2's
// accumulators are rounded into layer 3's A fragments (the C layout of two
// n-tiles is the A layout of one k-step), so no activation leaves the
// registers; layer 3 runs in 64-column chunks whose max over the 16 rows
// is folded into a per-warp running max in shared memory.

#include "bf16_mma.cuh"
#include "slab_select.cuh"

namespace {

using s4g_slab::kCentroidTile;
using s4g_slab::kKeyTile;
using s4g_slab::kWindow;
using s4g_slab::kWords;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCentroidsPerBlock = 32;
static_assert(kCentroidTile % kCentroidsPerBlock == 0,
              "a block must not straddle two centroid tiles");
constexpr int kC1 = 128;    // layer-1 width (A fragments of layer 2)
constexpr int kC2 = 128;    // layer-2 width (A fragments of layer 3)
constexpr int kMaxC3 = 256;
constexpr int kChunk = 64;  // layer-3 columns per pass (8 n-tiles)
constexpr int kMaxK = 128;
constexpr int kKSteps = kC1 / 16;
static_assert(kC1 == kC2, "W2t and W3t rows share one stride");
// Words (bf16 pairs) per transposed weight row, +4 words of padding: the 8
// rows x 4 words of a B fragment then fall into 32 distinct banks.
constexpr int kWStride = kC1 / 2 + 4;

constexpr size_t kPhase1Bytes =
    3 * sizeof(float) * kWindow + 2 * sizeof(unsigned) * kWarps * kWords;
constexpr size_t kPhase2Bytes =
    sizeof(unsigned) * (kC2 + kMaxC3) * kWStride +
    sizeof(float) * (3 * kC1 + kC1 + kC2 + kMaxC3 + kWarps * kMaxC3);
constexpr size_t kUnionBytes =
    kPhase1Bytes > kPhase2Bytes ? kPhase1Bytes : kPhase2Bytes;
static_assert(kUnionBytes % 16 == 0, "rel must stay 16-byte aligned");

// Layer 1 of one slot at one column: ReLU(((rx*w0 + ry*w1) + rz*w2) + b1),
// rounded after every operation (the weights are bf16 values, so every
// product is exact anyway).
__device__ __forceinline__ float layer1(const float* r, const float* w1s,
                                        const float* b1s, int col) {
  const float h = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r[0], w1s[col]),
                          __fmul_rn(r[1], w1s[kC1 + col])),
                __fmul_rn(r[2], w1s[2 * kC1 + col])),
      b1s[col]);
  return fmaxf(h, 0.f);
}

__global__ void __launch_bounds__(kThreads, 1)
sa1_fused_kernel(const float* __restrict__ pts,
                 const float* __restrict__ cents,
                 const int* __restrict__ lo_tile,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ w3, const float* __restrict__ b3,
                 int n, int m, int ntile, float r2, int k, int kpad, int c3,
                 int stratified, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Phase 1: the key window and each warp's ballot words / prefixes.
  float* kx = reinterpret_cast<float*>(smem);
  float* ky = kx + kWindow;
  float* kz = ky + kWindow;
  unsigned* words_all = reinterpret_cast<unsigned*>(kz + kWindow);
  int* prefix_all = reinterpret_cast<int*>(words_all + kWarps * kWords);
  // Phase 2, over the same bytes: the weights and each warp's running max.
  unsigned* w2t = reinterpret_cast<unsigned*>(smem);
  unsigned* w3t = w2t + kC2 * kWStride;
  float* w1s = reinterpret_cast<float*>(w3t + kMaxC3 * kWStride);
  float* b1s = w1s + 3 * kC1;
  float* b2s = b1s + kC1;
  float* b3s = b2s + kC2;
  float* pool_all = b3s + kMaxC3;
  // Both phases: the selected slots' rel and each centroid's count.
  float* rel = reinterpret_cast<float*>(smem + kUnionBytes);
  int* cnt_s = reinterpret_cast<int*>(rel + kCentroidsPerBlock * kpad * 3);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCentroidsPerBlock;
  const int base = lo_tile[b * ntile + c0 / kCentroidTile] * kKeyTile;
  s4g_slab::load_window(pts + static_cast<size_t>(b) * 3 * n, n, base, kx,
                        ky, kz);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* C = cents + static_cast<size_t>(b) * 3 * m;
  const int nc = min(c0 + kCentroidsPerBlock, m) - c0;

  // ---- phase 1: select each centroid's slots, keep their rel ----
  {
    unsigned* words = words_all + warp * kWords;
    int* prefix = prefix_all + warp * kWords;
    for (int cl = warp; cl < nc; cl += kWarps) {
      const int c = c0 + cl;
      const float cx = C[c], cy = C[m + c], cz = C[2 * m + c];
      const int total = s4g_slab::scan_window(kx, ky, kz, cx, cy, cz, r2,
                                              words, prefix, lane);
      const int count = min(total, k);
      float* rc = rel + cl * kpad * 3;
      int first = 0;
      // Slots count..kpad-1 (duplicate fill, and the rows that pad K to a
      // multiple of 16) repeat slot 0: a repeat never changes the max.
      for (int s0 = 0; s0 < kpad; s0 += 32) {
        const int slot = s0 + lane;
        int j = 0;
        if (slot < count) {
          const int target =
              s4g_slab::slot_target(slot, total, k, stratified);
          j = s4g_slab::rank_to_local(words, prefix, target);
        }
        if (s0 == 0) first = __shfl_sync(S4G_FULL_MASK, j, 0);
        if (slot < kpad) {
          if (slot >= count) j = first;
          rc[slot * 3 + 0] = round_bf16(__fsub_rn(kx[j], cx));
          rc[slot * 3 + 1] = round_bf16(__fsub_rn(ky[j], cy));
          rc[slot * 3 + 2] = round_bf16(__fsub_rn(kz[j], cz));
        }
      }
      if (lane == 0) cnt_s[cl] = count;
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- stage the weights over the dead window ----
  for (int i = threadIdx.x; i < kC2 * (kC1 / 2); i += kThreads) {
    const int col = i % kC2, kw = i / kC2;   // coalesced reads along col
    w2t[col * kWStride + kw] =
        pack_bf16(w2[(2 * kw) * kC2 + col], w2[(2 * kw + 1) * kC2 + col]);
  }
  for (int i = threadIdx.x; i < c3 * (kC2 / 2); i += kThreads) {
    const int col = i % c3, kw = i / c3;
    w3t[col * kWStride + kw] =
        pack_bf16(w3[(2 * kw) * c3 + col], w3[(2 * kw + 1) * c3 + col]);
  }
  for (int i = threadIdx.x; i < 3 * kC1; i += kThreads)
    w1s[i] = round_bf16(w1[i]);
  for (int i = threadIdx.x; i < kC1; i += kThreads) b1s[i] = b1[i];
  for (int i = threadIdx.x; i < kC2; i += kThreads) b2s[i] = b2[i];
  for (int i = threadIdx.x; i < c3; i += kThreads) b3s[i] = b3[i];
  __syncthreads();

  // ---- phase 2: the chain and the pool, one warp per centroid ----
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  float* pool = pool_all + warp * kMaxC3;
  for (int cl = warp; cl < nc; cl += kWarps) {
    float* o = out + (static_cast<size_t>(b) * m + c0 + cl) * c3;
    if (cnt_s[cl] == 0) {   // nothing in range: a zero row
      for (int col = lane; col < c3; col += 32) o[col] = 0.f;
      continue;
    }
    for (int col = lane; col < c3; col += 32) pool[col] = 0.f;  // ReLU >= 0
    __syncwarp();
    const float* rc = rel + cl * kpad * 3;
    for (int r0 = 0; r0 < kpad; r0 += 16) {
      const float* ra = rc + (r0 + g) * 3;      // fragment row g
      const float* rb = rc + (r0 + g + 8) * 3;  // fragment row g + 8

      // Layer 1 straight into A fragments (k-step ks = columns 16ks..+15).
      unsigned a1[kKSteps][4];
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const int col = ks * 16 + 2 * t;
        a1[ks][0] = pack_bf16(layer1(ra, w1s, b1s, col),
                              layer1(ra, w1s, b1s, col + 1));
        a1[ks][1] = pack_bf16(layer1(rb, w1s, b1s, col),
                              layer1(rb, w1s, b1s, col + 1));
        a1[ks][2] = pack_bf16(layer1(ra, w1s, b1s, col + 8),
                              layer1(ra, w1s, b1s, col + 9));
        a1[ks][3] = pack_bf16(layer1(rb, w1s, b1s, col + 8),
                              layer1(rb, w1s, b1s, col + 9));
      }

      // Layer 2, two n-tiles (16 columns) at a time; + b2, ReLU, -> bf16
      // straight into layer 3's A fragment of k-step j.
      unsigned a2[kKSteps][4];
#pragma unroll
      for (int j = 0; j < kKSteps; ++j) {
        float acc[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned* wr =
                w2t + ((2 * j + h) * 8 + g) * kWStride + ks * 8 + t;
            mma_bf16(acc[h], a1[ks], wr[0], wr[4]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = (2 * j + h) * 8 + 2 * t;
          a2[j][2 * h] = pack_bf16(fmaxf(acc[h][0] + b2s[col], 0.f),
                                   fmaxf(acc[h][1] + b2s[col + 1], 0.f));
          a2[j][2 * h + 1] = pack_bf16(fmaxf(acc[h][2] + b2s[col], 0.f),
                                       fmaxf(acc[h][3] + b2s[col + 1], 0.f));
        }
      }

      // Layer 3 in 64-column chunks; + b3, ReLU, max over the 16 rows.
      for (int ch = 0; ch < c3 / kChunk; ++ch) {
        float acc[8][4] = {};
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const unsigned* wr =
                w3t + ((ch * 8 + nt) * 8 + g) * kWStride + ks * 8 + t;
            mma_bf16(acc[nt], a2[ks], wr[0], wr[4]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = ch * kChunk + nt * 8 + 2 * t;
          float v0 = fmaxf(fmaxf(acc[nt][0] + b3s[col], 0.f),
                           fmaxf(acc[nt][2] + b3s[col], 0.f));
          float v1 = fmaxf(fmaxf(acc[nt][1] + b3s[col + 1], 0.f),
                           fmaxf(acc[nt][3] + b3s[col + 1], 0.f));
          for (int off = 4; off < 32; off <<= 1) {   // over the row groups
            v0 = fmaxf(v0, __shfl_xor_sync(S4G_FULL_MASK, v0, off));
            v1 = fmaxf(v1, __shfl_xor_sync(S4G_FULL_MASK, v1, off));
          }
          if (nt == g) {   // lane (g, t) keeps n-tile g's two columns
            pool[col] = fmaxf(pool[col], v0);
            pool[col + 1] = fmaxf(pool[col + 1], v1);
          }
        }
      }
    }
    __syncwarp();
    for (int col = lane; col < c3; col += 32) o[col] = pool[col];
    __syncwarp();
  }
}

}  // namespace

extern "C" int s4g_sa1_fused(const float* pts, const float* cents,
                             const int* lo_tile, const float* w1,
                             const float* b1, const float* w2,
                             const float* b2, const float* w3,
                             const float* b3, int b, int n, int m, int ntile,
                             float r2, int k, int c3, int stratified,
                             float* out, cudaStream_t stream) {
  if (k <= 0 || k > kMaxK || c3 <= 0 || c3 % kChunk != 0 || c3 > kMaxC3)
    return cudaErrorInvalidValue;
  const int kpad = (k + 15) / 16 * 16;
  const size_t smem = kUnionBytes +
                      sizeof(float) * kCentroidsPerBlock * kpad * 3 +
                      sizeof(int) * kCentroidsPerBlock;
  static size_t granted = 0;
  cudaError_t err = s4g_allow_smem(sa1_fused_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kCentroidsPerBlock - 1) / kCentroidsPerBlock, b);
  sa1_fused_kernel<<<grid, kThreads, smem, stream>>>(
      pts, cents, lo_tile, w1, b1, w2, b2, w3, b3, n, m, ntile, r2, k, kpad,
      c3, stratified, out);
  return cudaGetLastError();
}
