// Three nearest neighbours (K4).
//
// Replaces the TPU kernel s4g_tpu/ops/pallas/neighbor_kernels.py::
// _three_nn_kernel (wrapper three_nn_pallas, pallas_call at
// neighbor_kernels.py:111).  For every query, the 3 keys with the smallest
// f32 difference-form squared distance, ascending, ties to the lowest key
// index; returns the indices and those distances.
//
// What bounds it on this card: operations — N1 * N2 distance tests (131 M at
// the FP 25600 <- 5120 stage) against 12 B per point of input.  The exact
// difference form cannot contract into FMAs, so a pair costs ~9 FP32
// instructions plus the compare: at 132 SMs x 128 lanes that floor is about
// twice the FMA-rate bound.  Design, for Hopper:
// * register tiles: a thread owns kQ = 4 queries, so one key feeds four
//   independent sub -> mul -> add chains (ILP instead of warps to hide their
//   latency); the top-3 insertion is branch-free (keys ascend along the
//   sorted clouds' axis, so a warp would otherwise diverge on most keys);
// * packed keys: the block stages its keys in shared memory as float4
//   (x, y, z, 0), one 128-bit broadcast load per key for all four queries;
// * a key split: the grid is (query tiles x key chunks x B), and the wrapper
//   picks the chunk length (a multiple of 64 keys) from the card's SM count
//   so that a call puts at least four blocks on each SM where chunks that
//   short allow it (on an H100's 132 SMs at b = 1: 600 blocks at 25600 <-
//   5120, 160 at 5120 <- 1024).  Each block
//   keeps its chunk's top-3 by strict `<` over ascending keys (ties to the
//   lowest index inside the chunk) and writes it to scratch; a merge kernel
//   inserts the chunks' partials in chunk order with the same strict `<`,
//   which is the lexicographic (d, index) order across chunks: the result
//   is exact.  One chunk writes the output directly and launches no merge.
// What is left: the top-3 insertion, whose compares and selects per pair
// are as many instructions as the distance itself.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 4;                         // queries per thread
constexpr int kTileQ = kThreads * kQ;         // queries per block
constexpr int kStage = 2048;                  // keys staged at a time (32 KB)

// Insert (d, j) into the ascending top-3 (strict <: an equal distance keeps
// the entry that came first).  Branch-free: three compares and ten selects,
// so a warp whose lanes insert at different keys never diverges.
__device__ __forceinline__ void insert3(float d, int j, float& d0, float& d1,
                                        float& d2, int& i0, int& i1,
                                        int& i2) {
  const bool c0 = d < d0, c1 = d < d1, c2 = d < d2;
  i2 = c1 ? i1 : (c2 ? j : i2);
  d2 = c1 ? d1 : (c2 ? d : d2);
  i1 = c0 ? i0 : (c1 ? j : i1);
  d1 = c0 ? d0 : (c1 ? d : d1);
  i0 = c0 ? j : i0;
  d0 = c0 ? d : d0;
}

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ query, const float* __restrict__ key,
                int n1, int n2, int chunk, int* __restrict__ idx,
                float* __restrict__ dist) {
  __shared__ float4 sk[kStage];
  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int q0 = blockIdx.x * kTileQ + threadIdx.x;
  const float* Q = query + static_cast<size_t>(b) * 3 * n1;
  const float* K = key + static_cast<size_t>(b) * 3 * n2;

  float qx[kQ], qy[kQ], qz[kQ], d0[kQ], d1[kQ], d2[kQ];
  int i0[kQ], i1[kQ], i2[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = q0 + q * kThreads;
    const bool active = i < n1;
    qx[q] = active ? Q[i] : 0.f;
    qy[q] = active ? Q[n1 + i] : 0.f;
    qz[q] = active ? Q[2 * n1 + i] : 0.f;
    d0[q] = d1[q] = d2[q] = INFINITY;
    i0[q] = i1[q] = i2[q] = 0;
  }

  const int k_lo = split * chunk;
  const int k_hi = min(n2, k_lo + chunk);
  for (int t0 = k_lo; t0 < k_hi; t0 += kStage) {
    const int len = min(kStage, k_hi - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += kThreads)
      sk[j] = make_float4(K[t0 + j], K[n2 + t0 + j], K[2 * n2 + t0 + j], 0.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const float4 k4 = sk[j];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float d = s4g_sqdist(qx[q], qy[q], qz[q], k4.x, k4.y, k4.z);
        insert3(d, t0 + j, d0[q], d1[q], d2[q], i0[q], i1[q], i2[q]);
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = q0 + q * kThreads;
    if (i >= n1) continue;
    if (nsplit == 1) {   // (B, N1, 3): the result
      const size_t o = (static_cast<size_t>(b) * n1 + i) * 3;
      idx[o] = i0[q]; idx[o + 1] = i1[q]; idx[o + 2] = i2[q];
      dist[o] = d0[q]; dist[o + 1] = d1[q]; dist[o + 2] = d2[q];
    } else {             // (B, nsplit, 3, N1): this chunk's partial
      const size_t o = (static_cast<size_t>(b) * nsplit + split) * 3 * n1 + i;
      idx[o] = i0[q]; idx[o + n1] = i1[q]; idx[o + 2 * n1] = i2[q];
      dist[o] = d0[q]; dist[o + n1] = d1[q]; dist[o + 2 * n1] = d2[q];
    }
  }
}

// The chunks' partial top-3s, inserted in chunk order (ascending key
// indices), into the (B, N1, 3) result.
__global__ void __launch_bounds__(kThreads)
three_nn_merge_kernel(const int* __restrict__ pidx,
                      const float* __restrict__ pdist, int n1, int nsplit,
                      int* __restrict__ idx, float* __restrict__ dist) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n1) return;
  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int s = 0; s < nsplit; ++s) {
    const size_t o = (static_cast<size_t>(b) * nsplit + s) * 3 * n1 + i;
#pragma unroll
    for (int r = 0; r < 3; ++r)
      insert3(pdist[o + r * n1], pidx[o + r * n1], d0, d1, d2, i0, i1, i2);
  }
  const size_t o = (static_cast<size_t>(b) * n1 + i) * 3;
  idx[o] = i0; idx[o + 1] = i1; idx[o + 2] = i2;
  dist[o] = d0; dist[o + 1] = d1; dist[o + 2] = d2;
}

}  // namespace

// `chunk` keys per block (the wrapper's split); with more than one chunk the
// partials go to pidx / pdist, (B, nsplit, 3, N1), and the merge kernel
// writes idx / dist.  Both launches belong to one call.
extern "C" int s4g_three_nn(const float* query, const float* key, int b,
                            int n1, int n2, int chunk, int* pidx,
                            float* pdist, int* idx, float* dist,
                            cudaStream_t stream) {
  if (b <= 0 || n1 <= 0 || n2 < 3 || chunk <= 0) return cudaErrorInvalidValue;
  const int nsplit = (n2 + chunk - 1) / chunk;
  if (nsplit > 1 && (pidx == nullptr || pdist == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((n1 + kTileQ - 1) / kTileQ, nsplit, b);
  three_nn_kernel<<<grid, kThreads, 0, stream>>>(
      query, key, n1, n2, chunk, nsplit == 1 ? idx : pidx,
      nsplit == 1 ? dist : pdist);
  if (nsplit > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 mgrid((n1 + kThreads - 1) / kThreads, b);
    three_nn_merge_kernel<<<mgrid, kThreads, 0, stream>>>(pidx, pdist, n1,
                                                         nsplit, idx, dist);
  }
  return cudaGetLastError();
}
