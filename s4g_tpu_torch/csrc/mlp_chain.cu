// BN-folded SharedMLP chain with an optional group max (K7): every layer of
// a point-wise MLP on one tile of rows, in one kernel.
//
// Replaces the TPU kernel s4g_tpu/ops/pallas/mlp_kernels.py::
// _mlp_chain_kernel as driven by mlp_chain_pallas (pallas_call at
// mlp_kernels.py:151).  Per row, with the compute type T (bf16 or f32):
// * the input row is T (the wrapper casts it);
// * layer i: y = x W_i (W_i the folded weight rounded to T, products summed
//   in f32) + b_i (f32), then ReLU where relu bit i is set; every layer but
//   the last is rounded to T;
// * with pool_k > 0: the max over each run of pool_k consecutive rows, in
//   f32.
// Output (P or P / pool_k, C_out) f32.  The TPU kernel's transposed input,
// lane padding to 128 and 2,048-row tiles are not carried over; weights come
// zero-padded to widths that are multiples of 16 (the wrapper packs them),
// so padded columns stay exactly 0 through every layer.
//
// What bounds it on this card: operations.  At curvature_model.yaml's full
// width a b = 1 forward's ten chains need ~2.0e11 FLOP of bf16 products
// (~0.21 ms at 989 TFLOP/s) against ~150 MB of chain inputs and outputs
// (~0.05 ms at 3.35 TB/s); the unfused route also writes and re-reads every
// hidden activation in f32.
// Design: a block owns a tile of TM rows (32 in bf16, or 16 where a 32-row
// tile does not fit shared memory; 16 in f32) and runs the whole chain on
// it; the tile's activations ping-pong between two
// shared-memory buffers in T and never reach device memory.  A pooled block
// owns whole groups (max(TM, pool_k) rows, walked TM rows at a time) and
// folds each sub-tile's last layer into a running max in shared memory, so
// only the pooled rows are written.  Eight warps share a layer's output
// columns in units of 16 (all TM rows of the unit): bf16 products run on
// the tensor cores (mma.sync m16n8k16, f32 sums), f32 products as FFMA (no
// TF32), both with the same fragment layout, so the epilogue is shared.
// Weights are read straight from device memory (L2-resident: at most 3 MB
// a layer); each warp reuses a weight fragment for every m-tile of the
// tile.  Not yet done: wgmma, TMA staging of weight slices, tiles above 32
// rows (each block re-reads the chain's weights).

#include <cuda_bf16.h>

#include "bf16_mma.cuh"
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLayers = 4;
constexpr int kUnitCols = 16;   // output columns per warp unit: 2 n-tiles
constexpr int kPadElems = 8;    // row padding of the activation buffers

struct Chain {
  const void* w[kMaxLayers];   // bf16: W^T (npad, kpad); f32: W (kpad, npad)
  const float* b[kMaxLayers];  // (npad,), zero-padded
  int kpad[kMaxLayers];        // layer i's padded input width
  int npad[kMaxLayers];        // layer i's padded output width
  int layers, relu_mask, c_in, c_out, p, pool_k, rows_per_block;
  int stride[2];               // elements per row of activation buffer 0 / 1
};

template <typename T>
__device__ __forceinline__ T zero_t();
template <>
__device__ __forceinline__ __nv_bfloat16 zero_t<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}
template <>
__device__ __forceinline__ float zero_t<float>() {
  return 0.f;
}

// One unit's product, bf16: c[mt][nt] += act rows (mt*16..+15) x W^T rows
// (col0 + nt*8..+7), over `depth` inputs; W^T rows are `kpad` long and `w`
// points at the first input taken.
template <int kMT>
__device__ __forceinline__ void unit_product(const __nv_bfloat16* act,
                                             int stride, const void* w,
                                             int kpad, int depth, int,
                                             int col0, float (&c)[kMT][2][4]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const unsigned* aw = reinterpret_cast<const unsigned*>(act);
  const int sw = stride / 2;   // words per activation row
  const int kw = kpad / 2;     // words per W^T row
  const unsigned* w0 =
      static_cast<const unsigned*>(w) + static_cast<size_t>(col0 + g) * kw + t;
  const unsigned* w1 = w0 + static_cast<size_t>(8) * kw;
#pragma unroll 2
  for (int ks = 0; ks < depth / 16; ++ks) {
    const unsigned b00 = __ldg(w0 + ks * 8), b01 = __ldg(w0 + ks * 8 + 4);
    const unsigned b10 = __ldg(w1 + ks * 8), b11 = __ldg(w1 + ks * 8 + 4);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const unsigned* ar = aw + (mt * 16 + g) * sw + ks * 8 + t;
      const unsigned a[4] = {ar[0], ar[8 * sw], ar[4], ar[8 * sw + 4]};
      mma_bf16(c[mt][0], a, b00, b01);
      mma_bf16(c[mt][1], a, b10, b11);
    }
  }
}

// The same product in f32 with FFMA, in the mma C layout: lane (g, t) holds
// rows g and g + 8 of each m-tile, columns 2t and 2t + 1 of each n-tile.
template <int kMT>
__device__ __forceinline__ void unit_product(const float* act, int stride,
                                             const void* w, int, int depth,
                                             int npad, int col0,
                                             float (&c)[kMT][2][4]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const float* wc = static_cast<const float*>(w) + col0 + 2 * t;
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    const float2 b0 =
        __ldg(reinterpret_cast<const float2*>(wc + static_cast<size_t>(k) * npad));
    const float2 b1 = __ldg(
        reinterpret_cast<const float2*>(wc + static_cast<size_t>(k) * npad + 8));
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float lo = act[(mt * 16 + g) * stride + k];
      const float hi = act[(mt * 16 + g + 8) * stride + k];
      c[mt][0][0] = fmaf(lo, b0.x, c[mt][0][0]);
      c[mt][0][1] = fmaf(lo, b0.y, c[mt][0][1]);
      c[mt][0][2] = fmaf(hi, b0.x, c[mt][0][2]);
      c[mt][0][3] = fmaf(hi, b0.y, c[mt][0][3]);
      c[mt][1][0] = fmaf(lo, b1.x, c[mt][1][0]);
      c[mt][1][1] = fmaf(lo, b1.y, c[mt][1][1]);
      c[mt][1][2] = fmaf(hi, b1.x, c[mt][1][2]);
      c[mt][1][3] = fmaf(hi, b1.y, c[mt][1][3]);
    }
  }
}

// Layer weights from input `k0` on (as unit_product takes them).
__device__ __forceinline__ const void* weights_from(const __nv_bfloat16*,
                                                    const void* w, int k0,
                                                    int) {
  return static_cast<const __nv_bfloat16*>(w) + k0;
}
__device__ __forceinline__ const void* weights_from(const float*,
                                                    const void* w, int k0,
                                                    int npad) {
  return static_cast<const float*>(w) + static_cast<size_t>(k0) * npad;
}

// The last layer's columns (col, col + 1) of sub-tile row r = mt*16 + h*8 +
// g: with pool_k, into the running max of its group (`pool` row group,
// column pool_col; one lane per group after shuffles over min(pool_k, 8)
// rows); else straight out.  Every lane of the warp calls it.
__device__ __forceinline__ void emit_last(float v0, float v1, int r, int col,
                                          int sub, int row0, int pool_k,
                                          int p, int c_out, int span,
                                          float* pool, int pool_stride,
                                          int pool_col,
                                          float* __restrict__ out) {
  const int g = (threadIdx.x % 32) >> 2;
  if (pool_k) {
    for (int off = 1; off < span; off <<= 1) {
      v0 = fmaxf(v0, __shfl_xor_sync(S4G_FULL_MASK, v0, 4 * off));
      v1 = fmaxf(v1, __shfl_xor_sync(S4G_FULL_MASK, v1, 4 * off));
    }
    // One lane per group holds the max of its rows; the warp owns these
    // columns, so no other thread writes them.
    if (g % span == 0) {
      float* pr = pool + ((sub + r) / pool_k) * pool_stride + pool_col;
      pr[0] = fmaxf(pr[0], v0);
      pr[1] = fmaxf(pr[1], v1);
    }
  } else {
    const int row = row0 + r;
    if (row < p) {
      float* o = out + static_cast<size_t>(row) * c_out;
      if (col < c_out) o[col] = v0;
      if (col + 1 < c_out) o[col + 1] = v1;
    }
  }
}

// Two adjacent columns of a hidden activation, rounded to T, into a buffer.
__device__ __forceinline__ void store_pair(__nv_bfloat16* buf, int idx,
                                           float v0, float v1) {
  *reinterpret_cast<unsigned*>(buf + idx) = pack_bf16(v0, v1);
}
__device__ __forceinline__ void store_pair(float* buf, int idx, float v0,
                                           float v1) {
  buf[idx] = v0;
  buf[idx + 1] = v1;
}

template <typename T, int kMT>
__global__ void __launch_bounds__(kThreads)
mlp_chain_kernel(const T* __restrict__ x, Chain ch, float* __restrict__ out) {
  constexpr int kTileRows = 16 * kMT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bufs[2];
  bufs[0] = reinterpret_cast<T*>(smem);
  bufs[1] = bufs[0] + kTileRows * ch.stride[0];
  float* pool = reinterpret_cast<float*>(bufs[1] + kTileRows * ch.stride[1]);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int block_row0 = blockIdx.x * ch.rows_per_block;
  const int last = ch.layers - 1;
  const int n_last = ch.npad[last];
  const int pool_k = ch.pool_k;
  const int groups = pool_k ? ch.rows_per_block / pool_k : 0;
  for (int i = threadIdx.x; i < groups * n_last; i += kThreads)
    pool[i] = -INFINITY;
  // Rows of one group that a lane reduces with shuffles before touching the
  // running max: min(pool_k, 8) consecutive g.
  const int span = pool_k < 8 ? pool_k : 8;

  for (int sub = 0; sub < ch.rows_per_block; sub += kTileRows) {
    const int row0 = block_row0 + sub;
    const int kpad0 = ch.kpad[0];
    for (int i = threadIdx.x; i < kTileRows * kpad0; i += kThreads) {
      const int r = i / kpad0, col = i - r * kpad0;
      const int row = row0 + r;
      bufs[0][r * ch.stride[0] + col] =
          (row < ch.p && col < ch.c_in)
              ? x[static_cast<size_t>(row) * ch.c_in + col]
              : zero_t<T>();
    }
    __syncthreads();

    for (int l = 0; l <= last; ++l) {
      const T* in = bufs[l & 1];
      T* nxt = bufs[(l + 1) & 1];
      const int stride_in = ch.stride[l & 1];
      const int stride_out = ch.stride[(l + 1) & 1];
      const int npad = ch.npad[l];
      const float* bias = ch.b[l];
      const bool relu = (ch.relu_mask >> l) & 1;
      for (int u = warp; u < npad / kUnitCols; u += kWarps) {
        const int col0 = u * kUnitCols;
        float c[kMT][2][4] = {};
        unit_product<kMT>(in, stride_in, ch.w[l], ch.kpad[l], ch.kpad[l],
                          npad, col0, c);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int col = col0 + nt * 8 + 2 * t;
            const float bias0 = bias[col], bias1 = bias[col + 1];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = mt * 16 + h * 8 + g;   // row in the sub-tile
              float v0 = c[mt][nt][2 * h] + bias0;
              float v1 = c[mt][nt][2 * h + 1] + bias1;
              if (relu) {
                v0 = fmaxf(v0, 0.f);
                v1 = fmaxf(v1, 0.f);
              }
              if (l < last)
                store_pair(nxt, r * stride_out + col, v0, v1);
              else
                emit_last(v0, v1, r, col, sub, row0, pool_k, ch.p, ch.c_out,
                          span, pool, n_last, col, out);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (pool_k) {
    const int group0 = block_row0 / pool_k;
    const int num_groups = ch.p / pool_k;
    for (int i = threadIdx.x; i < groups * ch.c_out; i += kThreads) {
      const int gl = i / ch.c_out, col = i - gl * ch.c_out;
      if (group0 + gl < num_groups)
        out[static_cast<size_t>(group0 + gl) * ch.c_out + col] =
            pool[gl * n_last + col];
    }
  }
}

// One layer whose row tile does not fit shared memory whole (its input is
// wider than ~7,250 bf16 / ~3,620 f32 channels, or its pooled maxima too
// wide): the same function as mlp_chain_kernel on that one layer.  A block
// owns max(TM, pool_k) rows and walks the output columns in passes of
// kPassCols (a unit of 16 per warp); per pass and TM-row sub-tile it stages
// the input kWideChunk channels at a time and every warp adds the chunk's
// products to its unit's f32 sums in registers, in the order the whole-
// layer product takes them.  After the last chunk the bias, the ReLU and
// the output or the running group max are applied once, as emit_last does
// for the last layer of a chain.
constexpr int kWideChunk = 512;
constexpr int kPassCols = kWarps * kUnitCols;

template <typename T, int kMT>
__global__ void __launch_bounds__(kThreads)
mlp_wide_kernel(const T* __restrict__ x, Chain ch, float* __restrict__ out) {
  constexpr int kTileRows = 16 * kMT;
  constexpr int kStride = kWideChunk + kPadElems;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  float* pool = reinterpret_cast<float*>(buf + kTileRows * kStride);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int block_row0 = blockIdx.x * ch.rows_per_block;
  const int kpad = ch.kpad[0], npad = ch.npad[0];
  const int pool_k = ch.pool_k;
  const int groups = pool_k ? ch.rows_per_block / pool_k : 0;
  const int span = pool_k < 8 ? pool_k : 8;
  const bool relu = ch.relu_mask & 1;

  for (int pc0 = 0; pc0 < npad; pc0 += kPassCols) {
    for (int i = threadIdx.x; i < groups * kPassCols; i += kThreads)
      pool[i] = -INFINITY;
    const int col0 = pc0 + warp * kUnitCols;
    const bool mine = col0 < npad;   // uniform over the warp
    for (int sub = 0; sub < ch.rows_per_block; sub += kTileRows) {
      const int row0 = block_row0 + sub;
      float c[kMT][2][4] = {};
      for (int k0 = 0; k0 < kpad; k0 += kWideChunk) {
        const int depth = min(kWideChunk, kpad - k0);
        for (int i = threadIdx.x; i < kTileRows * depth; i += kThreads) {
          const int r = i / depth, col = i - r * depth;
          const int row = row0 + r, kc = k0 + col;
          buf[r * kStride + col] =
              (row < ch.p && kc < ch.c_in)
                  ? x[static_cast<size_t>(row) * ch.c_in + kc]
                  : zero_t<T>();
        }
        __syncthreads();
        if (mine)
          unit_product<kMT>(buf, kStride, weights_from(buf, ch.w[0], k0, npad),
                            kpad, depth, npad, col0, c);
        __syncthreads();
      }
      if (!mine) continue;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = col0 + nt * 8 + 2 * t;
          const float bias0 = ch.b[0][col], bias1 = ch.b[0][col + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = c[mt][nt][2 * h] + bias0;
            float v1 = c[mt][nt][2 * h + 1] + bias1;
            if (relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            emit_last(v0, v1, mt * 16 + h * 8 + g, col, sub, row0, pool_k,
                      ch.p, ch.c_out, span, pool, kPassCols, col - pc0, out);
          }
        }
      }
    }
    __syncthreads();
    if (pool_k) {
      const int group0 = block_row0 / pool_k;
      const int num_groups = ch.p / pool_k;
      for (int i = threadIdx.x; i < groups * kPassCols; i += kThreads) {
        const int gl = i / kPassCols, col = pc0 + i % kPassCols;
        if (group0 + gl < num_groups && col < ch.c_out)
          out[static_cast<size_t>(group0 + gl) * ch.c_out + col] = pool[i];
      }
      __syncthreads();
    }
  }
}

// Shared memory of a TM-row tile of chain `ch` (sets its row and buffer
// geometry).
template <typename T>
size_t tile_smem(Chain& ch, int tile_rows) {
  ch.rows_per_block = ch.pool_k > tile_rows ? ch.pool_k : tile_rows;
  // Buffer 0 holds the inputs of the even layers, buffer 1 of the odd ones.
  int width[2] = {0, 0};
  for (int l = 0; l < ch.layers; ++l)
    width[l & 1] = ch.kpad[l] > width[l & 1] ? ch.kpad[l] : width[l & 1];
  for (int i = 0; i < 2; ++i)
    ch.stride[i] = width[i] ? width[i] + kPadElems : 0;
  const int groups = ch.pool_k ? ch.rows_per_block / ch.pool_k : 0;
  return sizeof(T) * tile_rows * (ch.stride[0] + ch.stride[1]) +
         sizeof(float) * groups * ch.npad[ch.layers - 1];
}

template <typename T, int kMT>
cudaError_t launch(const void* x, Chain ch, float* out, cudaStream_t stream) {
  const size_t smem = tile_smem<T>(ch, 16 * kMT);
  if (smem > kS4gMaxSmem) return cudaErrorInvalidValue;
  static size_t granted = 0;
  const cudaError_t err =
      s4g_allow_smem(mlp_chain_kernel<T, kMT>, smem, &granted);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (static_cast<long long>(ch.p) + ch.rows_per_block - 1) /
      ch.rows_per_block;
  mlp_chain_kernel<T, kMT><<<static_cast<unsigned>(blocks), kThreads, smem,
                             stream>>>(static_cast<const T*>(x), ch, out);
  return cudaGetLastError();
}

template <typename T, int kMT>
cudaError_t launch_wide(const void* x, Chain ch, float* out,
                        cudaStream_t stream) {
  constexpr int kTileRows = 16 * kMT;
  ch.rows_per_block = ch.pool_k > kTileRows ? ch.pool_k : kTileRows;
  const int groups = ch.pool_k ? ch.rows_per_block / ch.pool_k : 0;
  const size_t smem = sizeof(T) * kTileRows * (kWideChunk + kPadElems) +
                      sizeof(float) * groups * kPassCols;
  static size_t granted = 0;
  const cudaError_t err =
      s4g_allow_smem(mlp_wide_kernel<T, kMT>, smem, &granted);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (static_cast<long long>(ch.p) + ch.rows_per_block - 1) /
      ch.rows_per_block;
  mlp_wide_kernel<T, kMT><<<static_cast<unsigned>(blocks), kThreads, smem,
                            stream>>>(static_cast<const T*>(x), ch, out);
  return cudaGetLastError();
}

}  // namespace

// x (P, c_in) in the compute type; per layer i < layers: w_i packed as in
// Chain (bf16 or f32), b_i (npad_i,) f32; kpad0 the padded input width,
// n0..n3 the padded output widths (multiples of 16); relu_mask bit i for
// layer i; pool_k 0 or a power of two dividing P; bf16 1 or 0 (f32).
// out (P or P / pool_k, c_out) f32.  One layer whose tile does not fit
// even at 16 rows runs on mlp_wide_kernel.  Refuses (cudaErrorInvalidValue)
// shapes it does not hold, among them chains of several layers whose tiles
// exceed a block's shared memory even at 16 rows (`ops/mlp_chain.py`
// splits longer and wider chains into sub-chains that fit, or into single
// layers).
extern "C" int s4g_mlp_chain(const void* x, const void* w0, const float* b0,
                             const void* w1, const float* b1, const void* w2,
                             const float* b2, const void* w3, const float* b3,
                             int p, int c_in, int c_out, int layers,
                             int kpad0, int n0, int n1, int n2, int n3,
                             int relu_mask, int pool_k, int bf16, float* out,
                             cudaStream_t stream) {
  Chain ch;
  const void* ws[kMaxLayers] = {w0, w1, w2, w3};
  const float* bs[kMaxLayers] = {b0, b1, b2, b3};
  const int ns[kMaxLayers] = {n0, n1, n2, n3};
  if (layers < 1 || layers > kMaxLayers || p < 1 || c_in < 1 ||
      kpad0 < c_in || kpad0 % 16 != 0)
    return cudaErrorInvalidValue;
  if (pool_k < 0 || (pool_k && ((pool_k & (pool_k - 1)) || p % pool_k)))
    return cudaErrorInvalidValue;
  for (int l = 0; l < kMaxLayers; ++l) {
    ch.w[l] = ws[l];
    ch.b[l] = bs[l];
    ch.npad[l] = ns[l];
    ch.kpad[l] = l == 0 ? kpad0 : ns[l - 1];
    if (l < layers && (ns[l] < 16 || ns[l] % 16 != 0 || !ws[l] || !bs[l]))
      return cudaErrorInvalidValue;
  }
  if (c_out < 1 || c_out > ns[layers - 1]) return cudaErrorInvalidValue;
  ch.layers = layers;
  ch.relu_mask = relu_mask;
  ch.c_in = c_in;
  ch.c_out = c_out;
  ch.p = p;
  ch.pool_k = pool_k;
  if (bf16 == 1) {   // 32-row tiles, or 16 where 32 rows do not fit
    if (tile_smem<__nv_bfloat16>(ch, 32) <= kS4gMaxSmem)
      return launch<__nv_bfloat16, 2>(x, ch, out, stream);
    if (layers == 1 && tile_smem<__nv_bfloat16>(ch, 16) > kS4gMaxSmem)
      return launch_wide<__nv_bfloat16, 2>(x, ch, out, stream);
    return launch<__nv_bfloat16, 1>(x, ch, out, stream);
  }
  if (bf16 == 0) {
    if (layers == 1 && tile_smem<float>(ch, 16) > kS4gMaxSmem)
      return launch_wide<float, 1>(x, ch, out, stream);
    return launch<float, 1>(x, ch, out, stream);
  }
  return cudaErrorInvalidValue;
}
