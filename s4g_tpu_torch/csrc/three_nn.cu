// Three nearest neighbours (K4).
//
// Replaces the TPU kernel s4g_tpu/ops/pallas/neighbor_kernels.py::
// _three_nn_kernel (wrapper three_nn_pallas, pallas_call at
// neighbor_kernels.py:111).  For every query, the 3 keys with the smallest
// f32 difference-form squared distance, ascending, ties to the lowest key
// index; returns the indices and those distances.
//
// What bounds it on this card: operations — N1 * N2 distance tests (131 M at
// the FP 25600 <- 5120 stage, ~10 flops each) against 12 B per point of
// input.  Design: one thread per query keeps its top-3 (d, index) in
// registers; the block streams the keys through shared memory in ascending
// index order, so every thread reads the same key at once (a broadcast, no
// bank conflicts) and the strict-< insertion keeps the lowest index on ties.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kKeyChunk = 2048;

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ query, const float* __restrict__ key,
                int n1, int n2, int* __restrict__ idx,
                float* __restrict__ dist) {
  __shared__ float skx[kKeyChunk], sky[kKeyChunk], skz[kKeyChunk];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n1;
  const float* Q = query + static_cast<size_t>(b) * 3 * n1;
  const float* K = key + static_cast<size_t>(b) * 3 * n2;
  const float qx = active ? Q[i] : 0.f;
  const float qy = active ? Q[n1 + i] : 0.f;
  const float qz = active ? Q[2 * n1 + i] : 0.f;

  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int t0 = 0; t0 < n2; t0 += kKeyChunk) {
    const int len = min(kKeyChunk, n2 - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += kThreads) {
      skx[j] = K[t0 + j];
      sky[j] = K[n2 + t0 + j];
      skz[j] = K[2 * n2 + t0 + j];
    }
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const float d = s4g_sqdist(qx, qy, qz, skx[j], sky[j], skz[j]);
      if (d < d2) {
        const int jj = t0 + j;
        if (d < d1) {
          d2 = d1; i2 = i1;
          if (d < d0) { d1 = d0; i1 = i0; d0 = d; i0 = jj; }
          else { d1 = d; i1 = jj; }
        } else {
          d2 = d; i2 = jj;
        }
      }
    }
  }
  if (active) {
    const size_t o = (static_cast<size_t>(b) * n1 + i) * 3;
    idx[o] = i0; idx[o + 1] = i1; idx[o + 2] = i2;
    dist[o] = d0; dist[o + 1] = d1; dist[o + 2] = d2;
  }
}

}  // namespace

extern "C" int s4g_three_nn(const float* query, const float* key, int b,
                            int n1, int n2, int* idx, float* dist,
                            cudaStream_t stream) {
  const dim3 grid((n1 + kThreads - 1) / kThreads, b);
  three_nn_kernel<<<grid, kThreads, 0, stream>>>(query, key, n1, n2, idx,
                                                 dist);
  return cudaGetLastError();
}
