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
// zero-padded (the wrapper packs them), so padded columns stay exactly 0
// through every layer.
//
// What bounds it on this card: operations.  At curvature_model.yaml's full
// width a b = 1 forward's chains need ~2.0e11 FLOP of bf16 products
// (~0.21 ms at 989 TFLOP/s) against ~150 MB of chain inputs and outputs
// (~0.05 ms at 3.35 TB/s); the unfused route also writes and re-reads every
// hidden activation in f32.
//
// bf16 design (mlp_wg_kernel), for Hopper: a block owns tiles of 64 rows
// per consumer warpgroup (one or two warpgroups, 64 or 128 rows, the
// larger where shared memory allows) and runs the whole chain on each.  A
// warpgroup's input rows arrive by TMA (64 x 64 boxes; the wrapper pads a
// row to a multiple of 8 channels, TMA fills the rest of the tile with
// zeros) straight into the 128-byte-swizzled K-major layout that wgmma's A
// descriptor reads; the tile's activations then ping-pong between two such
// shared-memory buffers in bf16, so a layer is wgmma.mma_async m64n128k16
// with f32 sums in registers, A and B both from shared memory.  The weights
// (W^T (N, K) bf16, zero-padded to K a multiple of 64 and N of 128) reach
// the block by TMA too: one producer warp walks the same sequence as the
// consumers (tile, layer, 128-column chunk, 64-wide K slice) and keeps a
// ring of 2-4 16 KB stages loaded (cp.async.bulk.tensor, full and empty
// mbarriers), so the next slice loads while wgmma runs on this one; with
// two warpgroups each slice serves 128 rows.  The epilogue adds the bias
// (loaded into registers before the chunk's products, so its latency hides
// behind them), applies the ReLU and rounds to bf16 into the other buffer;
// the last layer writes f32 rows, or folds them into the group max (bias
// and ReLU first, both monotone; the max over a warp's rows as a
// reduce-scatter of shuffles, then an atomic max in shared memory across
// warps and sub-tiles).  Blocks are persistent (as many as are resident,
// walking the tiles).  A single-layer launch may also split its output
// columns over blocks, so a layer with few rows (FP1: 1,024) still fills
// the card; the wrapper runs such chains one layer per launch
// (ops/mlp_chain.py).
// What is left (a per-phase clock profile of the block): the products
// wait on each chunk's epilogue (one accumulator set), 64-row tiles (SA3)
// are near L2's bandwidth for the weights they re-read, and a tile's input
// load is not overlapped with the previous tile.
// f32 design (mlp_chain_kernel): 16-row tiles, eight warps sharing a
// layer's output columns in units of 16, FFMA products in the mma C layout
// (no TF32), weights read from L2.
// A single layer whose row tile fits neither (its input wider than ~1,500
// bf16 / ~3,600 f32 channels) runs on mlp_wide_kernel: mma.sync m16n8k16
// (bf16) or FFMA (f32), its input channels staged 512 at a time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

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


// ---------------------------------------------------------------------------
// bf16 chains on wgmma with TMA-staged weights.

constexpr int kWgN = 128;                 // output columns per wgmma chunk
constexpr int kAtom = 64;                 // K elements per 128-byte row
constexpr int kStageBytes = kWgN * 128;   // one K slice of 128 W^T rows
constexpr int kMaxStages = 4;
constexpr int kSmemAlign = 1024;          // swizzle atoms sit on 1 KB
constexpr int kBarBytes = (2 * kMaxStages + 2) * 8;

struct WgChain {
  CUtensorMap tmap[kMaxLayers];   // W^T (npad, kpad) bf16: box 64 x 128
  CUtensorMap xmap;               // x (P, c_in) bf16: box 64 x 64
  const float* b[kMaxLayers];     // (npad,) f32, zero-padded
  int kpad[kMaxLayers], npad[kMaxLayers];
  int layers, relu_mask, c_in, c_out, p, pool_k;
  int rows_per_unit;              // max(tile rows, pool_k)
  int stages, w0, w1;             // ring stages; buffer widths (elements)
  int col_split, chunk_q;         // column groups of a tile, chunks each
  int units;                      // tiles x column groups
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One arrival on an mbarrier where `pred` holds, predicated rather than
// branched around, so no divergent path sits inside a wgmma pipeline.
__device__ __forceinline__ void release(uint32_t bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma descriptor of a K-major bf16 operand in shared memory, 128-byte
// swizzle: 8-row core groups 1,024 bytes apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 f32, this thread's 64) += A (64 x 16) * B (16 x 128), both
// bf16 K-major in shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
#define S4G_F8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : S4G_F8(0), S4G_F8(8), S4G_F8(16), S4G_F8(24), S4G_F8(32), S4G_F8(40),
        S4G_F8(48), S4G_F8(56)
      : "l"(da), "l"(db), "r"(1));
#undef S4G_F8
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_acc64(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A float max that orders like fmaxf for non-NaN values: non-negative
// floats order as ints, negative ones reversed as unsigned.
__device__ __forceinline__ void atomic_max_f32(float* a, float v) {
  if (!(__float_as_uint(v) >> 31))
    atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

// Byte offset of element (r, col) in an activation buffer of `rows` rows:
// 64-column atoms of rows x 128 bytes, 16-byte chunks XOR-swizzled by r % 8.
__device__ __forceinline__ int act_off(int r, int col, int rows) {
  return (col / kAtom) * rows * 128 + r * 128 +
         ((((col % kAtom) / 8) ^ (r % 8)) * 16) + (col % 8) * 2;
}

// The chunk range [lo, hi) of layer l that unit column group cg computes.
__device__ __forceinline__ void chunk_range(const WgChain& ch, int l, int cg,
                                            int& lo, int& hi) {
  const int n = ch.npad[l] / kWgN;
  lo = ch.layers == 1 ? cg * ch.chunk_q : 0;
  hi = ch.layers == 1 ? min(n, lo + ch.chunk_q) : n;
}

template <int kWG>
__global__ void __launch_bounds__(kWG * 128 + 32, 1)
mlp_wg_kernel(const __nv_bfloat16* __restrict__ x,
              const __grid_constant__ WgChain ch, float* __restrict__ out) {
  constexpr int kRows = 64 * kWG;
  constexpr int kConsumers = kWG * 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem =
      smem_raw + ((kSmemAlign - (raw & (kSmemAlign - 1))) & (kSmemAlign - 1));
  unsigned char* act[2] = {smem, smem + kRows * ch.w0 * 2};
  unsigned char* ring = act[1] + kRows * ch.w1 * 2;
  float* pool = reinterpret_cast<float*>(ring + ch.stages * kStageBytes);
  const int last = ch.layers - 1;
  const int n_last = ch.npad[last];
  const int groups = ch.pool_k >= 16 ? ch.rows_per_unit / ch.pool_k : 0;
  uint64_t* full = reinterpret_cast<uint64_t*>(pool + groups * n_last);
  uint64_t* empty = full + kMaxStages;
  uint64_t* in_full = empty + kMaxStages;   // per warpgroup: its input rows

  if (threadIdx.x == 0) {
    for (int i = 0; i < kWG; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(in_full + i))
                   : "memory");
    for (int s = 0; s < ch.stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(full + s))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(empty + s)),
                   "r"(kWG)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < groups * n_last; i += blockDim.x)
    pool[i] = -INFINITY;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * kWG) {   // the producer: one lane issues every copy
    if (lane != 0) return;
    for (int l = 0; l < ch.layers; ++l)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&ch.tmap[l]))
                   : "memory");
    int s = 0;
    uint32_t phase = 0;
    for (int unit = blockIdx.x; unit < ch.units; unit += gridDim.x) {
      const int cg = unit % ch.col_split;
      for (int sub = 0; sub < ch.rows_per_unit; sub += kRows) {
        for (int l = 0; l < ch.layers; ++l) {
          int c_lo, c_hi;
          chunk_range(ch, l, cg, c_lo, c_hi);
          const uint64_t map = reinterpret_cast<uint64_t>(&ch.tmap[l]);
          for (int c = c_lo; c < c_hi; ++c) {
            for (int ka = 0; ka < ch.kpad[l] / kAtom; ++ka) {
              mbar_wait(smem_u32(empty + s), phase ^ 1);
              const uint32_t bar = smem_u32(full + s);
              asm volatile(
                  "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                      "r"(bar),
                  "r"(kStageBytes)
                  : "memory");
              asm volatile(
                  "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
                  "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
                      smem_u32(ring + s * kStageBytes)),
                  "l"(map), "r"(ka * kAtom), "r"(c * kWgN), "r"(bar)
                  : "memory");
              if (++s == ch.stages) {
                s = 0;
                phase ^= 1;
              }
            }
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each sub-tile.
  const int wg = warp / 4, w4 = warp % 4;
  const int ct = threadIdx.x % 128;
  const int g = lane >> 2, t = lane & 3;
  const int in_atoms = ch.kpad[0] / kAtom;
  const uint64_t xmap = reinterpret_cast<uint64_t>(&ch.xmap);
  int s = 0;
  uint32_t phase = 0, in_phase = 0;
  for (int unit = blockIdx.x; unit < ch.units; unit += gridDim.x) {
    const int tile = unit / ch.col_split, cg = unit % ch.col_split;
    const int unit_row0 = tile * ch.rows_per_unit;
    for (int sub = 0; sub < ch.rows_per_unit; sub += kRows) {
      const int row0 = unit_row0 + sub;
      // The warpgroup's 64 input rows into buffer 0 by TMA, one 64 x 64
      // box per 64 columns in the buffer's swizzled layout; columns past
      // c_in and rows past P arrive as zeros.  The buffer is free once
      // every thread of the warpgroup is past the previous sub-tile.
      named_sync(1 + wg, 128);
      if (ct == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t bar = smem_u32(in_full + wg);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                bar),
            "r"(in_atoms * 64 * 128)
            : "memory");
        for (int a = 0; a < in_atoms; ++a)
          asm volatile(
              "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
              "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
                  smem_u32(act[0] + a * kRows * 128 + wg * 64 * 128)),
              "l"(xmap), "r"(a * kAtom), "r"(row0 + wg * 64), "r"(bar)
              : "memory");
      }
      mbar_wait(smem_u32(in_full + wg), in_phase);
      in_phase ^= 1;

      for (int l = 0; l <= last; ++l) {
        const uint32_t a_base =
            smem_u32(act[l & 1]) + static_cast<uint32_t>(wg * 64 * 128);
        unsigned char* nxt = act[(l + 1) & 1];
        const float* bias = ch.b[l];
        const bool relu = (ch.relu_mask >> l) & 1;
        const int katoms = ch.kpad[l] / kAtom;
        int c_lo, c_hi;
        chunk_range(ch, l, cg, c_lo, c_hi);
        for (int c = c_lo; c < c_hi; ++c) {
          // The chunk's biases, loaded before the products so that their
          // latency hides behind them (in the epilogue they would wait one
          // by one behind its stores).
          float2 bb[16];
#pragma unroll
          for (int j = 0; j < 16; ++j)
            bb[j] = __ldg(reinterpret_cast<const float2*>(
                bias + c * kWgN + j * 8 + 2 * t));
          float d[64];
#pragma unroll
          for (int i = 0; i < 64; ++i) d[i] = 0.f;
          int prev = s;
          for (int ka = 0; ka < katoms; ++ka) {
            mbar_wait(smem_u32(full + s), phase);
            const uint32_t a_at = a_base + ka * kRows * 128;
            const uint32_t b_at = smem_u32(ring + s * kStageBytes);
            fence_acc64(d);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_n128(d, wg_desc(a_at + kk * 32), wg_desc(b_at + kk * 32));
            wg_commit();
            // The slice before this one is no longer read: hand it back.
            wg_wait<1>();
            fence_acc64(d);
            release(smem_u32(empty + prev), ka > 0 && ct == 0);
            prev = s;
            if (++s == ch.stages) {
              s = 0;
              phase ^= 1;
            }
          }
          wg_wait<0>();
          fence_acc64(d);
          release(smem_u32(empty + prev), ct == 0);

          const int rbase = wg * 64 + w4 * 16 + g;   // row in the sub-tile
          if (l < last) {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int col = c * kWgN + j * 8 + 2 * t;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float v0 = d[4 * j + 2 * h] + bb[j].x;
                float v1 = d[4 * j + 2 * h + 1] + bb[j].y;
                if (relu) {
                  v0 = fmaxf(v0, 0.f);
                  v1 = fmaxf(v1, 0.f);
                }
                *reinterpret_cast<unsigned*>(
                    nxt + act_off(rbase + 8 * h, col, kRows)) =
                    pack_bf16(v0, v1);
              }
            }
          } else if (ch.pool_k >= 16) {
            // The warp's 16 rows lie in one group.  + bias and ReLU first
            // (both monotone, rounding included, so they commute with the
            // max), then the max over the 8 row lanes as a reduce-scatter:
            // each round keeps half the columns and trades the other half,
            // so lane (g, t) ends with n-tiles 2g and 2g + 1 (28 shuffles,
            // not 96), and every lane folds 4 maxima into the group's row.
            float v[32];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              v[2 * j] = fmaxf(d[4 * j], d[4 * j + 2]) + bb[j].x;
              v[2 * j + 1] = fmaxf(d[4 * j + 1], d[4 * j + 3]) + bb[j].y;
              if (relu) {
                v[2 * j] = fmaxf(v[2 * j], 0.f);
                v[2 * j + 1] = fmaxf(v[2 * j + 1], 0.f);
              }
            }
            float w[16], x[8], y[4];
            const bool hi4 = g & 4, hi2 = g & 2, hi1 = g & 1;
#pragma unroll
            for (int i = 0; i < 16; ++i)
              w[i] = fmaxf(hi4 ? v[i + 16] : v[i],
                           __shfl_xor_sync(S4G_FULL_MASK,
                                           hi4 ? v[i] : v[i + 16], 16));
#pragma unroll
            for (int i = 0; i < 8; ++i)
              x[i] = fmaxf(hi2 ? w[i + 8] : w[i],
                           __shfl_xor_sync(S4G_FULL_MASK,
                                           hi2 ? w[i] : w[i + 8], 8));
#pragma unroll
            for (int i = 0; i < 4; ++i)
              y[i] = fmaxf(hi1 ? x[i + 4] : x[i],
                           __shfl_xor_sync(S4G_FULL_MASK,
                                           hi1 ? x[i] : x[i + 4], 4));
            float* pr =
                pool + ((sub + wg * 64 + w4 * 16) / ch.pool_k) * n_last;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              atomic_max_f32(pr + c * kWgN + (2 * g + i / 2) * 8 + 2 * t +
                                 (i & 1),
                             y[i]);
          } else {
            // No pool, or groups of at most 8 rows inside a row half.
            const int span = ch.pool_k;
            const bool pairs = ch.c_out % 2 == 0;   // 8-byte aligned pairs
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int col = c * kWgN + j * 8 + 2 * t;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
                for (int o = 1; o < span; o <<= 1) {
                  v0 = fmaxf(v0, __shfl_xor_sync(S4G_FULL_MASK, v0, 4 * o));
                  v1 = fmaxf(v1, __shfl_xor_sync(S4G_FULL_MASK, v1, 4 * o));
                }
                v0 += bb[j].x;
                v1 += bb[j].y;
                if (relu) {
                  v0 = fmaxf(v0, 0.f);
                  v1 = fmaxf(v1, 0.f);
                }
                const int row = row0 + rbase + 8 * h;
                if (row >= ch.p || (span && g % span)) continue;
                const size_t orow = span ? row / span : row;
                float* o = out + orow * ch.c_out;
                if (pairs && col + 1 < ch.c_out) {
                  *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
                } else {
                  if (col < ch.c_out) o[col] = v0;
                  if (col + 1 < ch.c_out) o[col + 1] = v1;
                }
              }
            }
          }
        }
        if (l < last) {   // the next layer reads what this one wrote
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          named_sync(1 + wg, 128);
        }
      }
    }
    if (groups) {   // the unit's group maxima out, then reset
      named_sync(3, kConsumers);
      int c_lo, c_hi;
      chunk_range(ch, last, cg, c_lo, c_hi);
      const int col0 = c_lo * kWgN, ncol = (c_hi - c_lo) * kWgN;
      const int group0 = unit_row0 / ch.pool_k;
      for (int i = threadIdx.x; i < groups * ncol; i += kConsumers) {
        const int gl = i / ncol, col = col0 + i - gl * ncol;
        float* pr = pool + gl * n_last + col;
        if (col < ch.c_out && (group0 + gl) * ch.pool_k < ch.p)
          out[static_cast<size_t>(group0 + gl) * ch.c_out + col] = *pr;
        *pr = -INFINITY;
      }
      named_sync(3, kConsumers);
    }
  }
}

// Shared memory of an mlp_wg_kernel tile of `rows` rows and `stages` ring
// stages (sets the chain's buffer widths and unit rows); the wrapper's
// planner (ops/mlp_chain.py `_wg_smem`) copies this sum.
size_t wg_smem(WgChain& ch, int rows, int stages) {
  ch.w0 = ch.w1 = 0;
  for (int l = 0; l < ch.layers; ++l) {
    int& w = (l & 1) ? ch.w1 : ch.w0;
    w = ch.kpad[l] > w ? ch.kpad[l] : w;
  }
  ch.rows_per_unit = ch.pool_k > rows ? ch.pool_k : rows;
  const int groups = ch.pool_k >= 16 ? ch.rows_per_unit / ch.pool_k : 0;
  return kSmemAlign + static_cast<size_t>(rows) * (ch.w0 + ch.w1) * 2 +
         static_cast<size_t>(stages) * kStageBytes +
         static_cast<size_t>(groups) * ch.npad[ch.layers - 1] * 4 + kBarBytes;
}

// The tile the wg kernel takes: 128 rows with 4, 3 or 2 stages, else 64
// rows; 0 if none fits.
int wg_tile(WgChain& ch) {
  static const int kTiles[][2] = {{128, 4}, {128, 3}, {128, 2},
                                  {64, 4},  {64, 3},  {64, 2}};
  for (const auto& c : kTiles) {
    if (wg_smem(ch, c[0], c[1]) <= kS4gMaxSmem) {
      ch.stages = c[1];
      return c[0];
    }
  }
  return 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no link
// against libcuda).
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || !p) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A (rows, cols) row-major bf16 matrix as a TMA map of box_rows x 64
// boxes, 128-byte swizzle (elements outside the matrix arrive as zeros):
// layer weights W^T (npad, kpad) in 128-row boxes (one ring stage), the
// input x (P, c_in) in 64-row boxes (a warpgroup's rows).
cudaError_t bf16_map(CUtensorMap* map, const void* w, int cols, int rows,
                     int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  if (reinterpret_cast<uintptr_t>(w) % 16 || cols % 8)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kAtom, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
      strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kWG>
cudaError_t launch_wg(const void* x, WgChain& ch, float* out,
                      cudaStream_t stream) {
  const size_t smem = wg_smem(ch, 64 * kWG, ch.stages);
  const int threads = kWG * 128 + 32;
  static size_t granted = 0;
  cudaError_t err = s4g_allow_smem(mlp_wg_kernel<kWG>, smem, &granted);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = s4g_sm_count(&sms);
  if (err != cudaSuccess) return err;
  // Resident blocks per SM, queried once per shared-memory size.
  static size_t occ_smem[8] = {};
  static int occ[8] = {};
  int per_sm = 0;
  for (int i = 0; i < 8 && occ_smem[i]; ++i)
    if (occ_smem[i] == smem) per_sm = occ[i];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mlp_wg_kernel<kWG>, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidValue;
    for (int i = 0; i < 8; ++i) {
      if (!occ_smem[i]) {
        occ_smem[i] = smem;
        occ[i] = per_sm;
        break;
      }
    }
  }
  const long long slots = static_cast<long long>(sms) * per_sm;
  const long long tiles = (ch.p + ch.rows_per_unit - 1) / ch.rows_per_unit;
  // A single layer may split its columns over blocks: the fewest chunks a
  // block (q) that minimise waves x q, ties to the larger q.
  const int chunks = ch.layers == 1 ? ch.npad[0] / kWgN : 1;
  int best_q = chunks;
  long long best_cost = -1;
  for (int q = chunks; q >= 1; --q) {
    const long long groups = (chunks + q - 1) / q;
    const long long cost = (tiles * groups + slots - 1) / slots * q;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_q = q;
    }
  }
  ch.chunk_q = best_q;
  ch.col_split = (chunks + best_q - 1) / best_q;
  const long long units = tiles * ch.col_split;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  ch.units = static_cast<int>(units);
  const long long grid = units < slots ? units : slots;
  mlp_wg_kernel<kWG><<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), ch, out);
  return cudaGetLastError();
}

}  // namespace

// x (P, c_in) in the compute type (bf16 chains on mlp_wg_kernel: c_in a
// multiple of 8 and x 16-byte aligned, as TMA reads it); per layer i <
// layers: w_i packed (bf16:
// W^T (n_i, k_i); f32: W (k_i, n_i)), b_i (n_i,) f32; kpad0 the padded
// input width, n0..n3 the padded output widths (bf16: kpad0 a multiple of
// 64, n_i of 128; f32: multiples of 16); relu_mask bit i for layer i;
// pool_k 0 or a power of two dividing P; bf16 1 or 0 (f32).  out (P or
// P / pool_k, c_out) f32.  bf16 chains whose tile fits run on
// mlp_wg_kernel; f32 chains on mlp_chain_kernel; a single layer whose tile
// fits neither on mlp_wide_kernel.  Refuses (cudaErrorInvalidValue) shapes
// it does not hold, among them chains of several layers whose tiles exceed
// a block's shared memory (`ops/mlp_chain.py` splits longer and wider
// chains into sub-chains that fit, or into single layers).
extern "C" int s4g_mlp_chain(const void* x, const void* w0, const float* b0,
                             const void* w1, const float* b1, const void* w2,
                             const float* b2, const void* w3, const float* b3,
                             int p, int c_in, int c_out, int layers,
                             int kpad0, int n0, int n1, int n2, int n3,
                             int relu_mask, int pool_k, int bf16, float* out,
                             cudaStream_t stream) {
  const void* ws[kMaxLayers] = {w0, w1, w2, w3};
  const float* bs[kMaxLayers] = {b0, b1, b2, b3};
  const int ns[kMaxLayers] = {n0, n1, n2, n3};
  const int kalign = bf16 == 1 ? kAtom : 16, nalign = bf16 == 1 ? kWgN : 16;
  if (layers < 1 || layers > kMaxLayers || p < 1 || c_in < 1 ||
      kpad0 < c_in || kpad0 % kalign != 0 || (bf16 != 0 && bf16 != 1))
    return cudaErrorInvalidValue;
  if (pool_k < 0 || (pool_k && ((pool_k & (pool_k - 1)) || p % pool_k)))
    return cudaErrorInvalidValue;
  for (int l = 0; l < layers; ++l)
    if (ns[l] < nalign || ns[l] % nalign != 0 || !ws[l] || !bs[l])
      return cudaErrorInvalidValue;
  if (c_out < 1 || c_out > ns[layers - 1]) return cudaErrorInvalidValue;
  Chain ch;
  for (int l = 0; l < kMaxLayers; ++l) {
    ch.w[l] = ws[l];
    ch.b[l] = bs[l];
    ch.npad[l] = ns[l];
    ch.kpad[l] = l == 0 ? kpad0 : ns[l - 1];
  }
  ch.layers = layers;
  ch.relu_mask = relu_mask;
  ch.c_in = c_in;
  ch.c_out = c_out;
  ch.p = p;
  ch.pool_k = pool_k;
  if (bf16 == 1) {
    WgChain wc;
    for (int l = 0; l < kMaxLayers; ++l) {
      wc.b[l] = ch.b[l];
      wc.kpad[l] = ch.kpad[l];
      wc.npad[l] = ch.npad[l];
    }
    wc.layers = layers;
    wc.relu_mask = relu_mask;
    wc.c_in = c_in;
    wc.c_out = c_out;
    wc.p = p;
    wc.pool_k = pool_k;
    const int rows = wg_tile(wc);
    if (rows == 0) {
      if (layers == 1)
        return launch_wide<__nv_bfloat16, 2>(x, ch, out, stream);
      return cudaErrorInvalidValue;
    }
    for (int l = 0; l < layers; ++l) {
      const cudaError_t err =
          bf16_map(&wc.tmap[l], ws[l], wc.kpad[l], wc.npad[l], kWgN);
      if (err != cudaSuccess) return err;
    }
    const cudaError_t err = bf16_map(&wc.xmap, x, c_in, p, 64);
    if (err != cudaSuccess) return err;
    return rows == 128 ? launch_wg<2>(x, wc, out, stream)
                       : launch_wg<1>(x, wc, out, stream);
  }
  if (layers == 1 && tile_smem<float>(ch, 16) > kS4gMaxSmem)
    return launch_wide<float, 1>(x, ch, out, stream);
  return launch<float, 1>(x, ch, out, stream);
}
