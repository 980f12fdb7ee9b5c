// Fixed-order gather backward (K8).
//
// Replaces no TPU kernel.  The JAX package's gathers (s4g_tpu/ops/gather.py,
// ops/interpolate.py) differentiate through XLA's scatter-add, which adds a
// destination's contributions one after another in source order: the same
// gradients on every run (gather.py:5-7).  torch.gather's CUDA backward is a
// scatter-add with atomics, whose order changes from run to run wherever an
// index repeats (every padded ball-query group, every 3-NN interpolation),
// so the port's train step did not repeat.  This kernel is that backward
// with XLA's order:
//
//   grad_x[r, c] = sum over s in [offsets[r], offsets[r + 1]) of
//                  grad_out[order[s], c]
//
// where `order` lists the source rows sorted by destination row, ascending
// source row within a destination (a stable sort, made by the wrapper), and
// `offsets` are each destination's first slot.  The terms are added in that
// order in f32 (f64 for f64 gradients) and rounded once to the gradient's
// dtype; a destination with no source gets 0.  The plain twin
// (ops/gather.py::_gather_backward_plain) adds the same terms in the same
// order, so the two are equal bit for bit.
//
// What bounds it on this card: bytes — every source row of grad_out is read
// once and every destination row written once, plus the order and offset
// lists (4 B an entry); a few adds per 4-8 bytes.  Design:
// * one warp per destination row, no atomics, no shared memory: a lane
//   holds kVec channels of the row's running sum in registers (channels
//   c0 + lane + 32 * v), so a source row's read is 32 neighbouring
//   elements per v, coalesced;
// * the row's sources are walked kUnroll at a time: their order entries and
//   values are all loaded before the adds, which then run in slot order, so
//   the loads overlap and the sum's order stays fixed;
// * rows wider than 32 * kVec channels take more passes over their sources.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;                 // destination rows per block
constexpr int kVec = 4;                   // channels a lane holds per pass
constexpr int kPass = 32 * kVec;          // channels per pass
constexpr int kUnroll = 4;                // sources loaded ahead of the adds

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gather_backward_kernel(const T* __restrict__ grad_out,
                       const int* __restrict__ order,
                       const int* __restrict__ offsets, int rows, int c,
                       T* __restrict__ grad_x) {
  using A = typename Acc<T>::type;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int begin = offsets[row];
  const int end = offsets[row + 1];
  T* out = grad_x + static_cast<size_t>(row) * c;

  for (int c0 = 0; c0 < c; c0 += kPass) {
    A acc[kVec];
    bool live[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      acc[v] = A(0);
      live[v] = c0 + lane + 32 * v < c;
    }
    int s = begin;
    for (; s + kUnroll <= end; s += kUnroll) {
      A val[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* src = grad_out + static_cast<size_t>(order[s + u]) * c + c0
                       + lane;
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          val[u][v] = live[v] ? to_acc(src[32 * v]) : A(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[v] = add_rn(acc[v], val[u][v]);
    }
    for (; s < end; ++s) {
      const T* src = grad_out + static_cast<size_t>(order[s]) * c + c0 + lane;
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        if (live[v]) acc[v] = add_rn(acc[v], to_acc(src[32 * v]));
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      if (live[v]) store(out + c0 + lane + 32 * v, acc[v]);
  }
}

template <typename T>
cudaError_t launch(const void* grad_out, const int* order, const int* offsets,
                   int rows, int c, void* grad_x, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  gather_backward_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(grad_out), order, offsets, rows, c,
      static_cast<T*>(grad_x));
  return cudaGetLastError();
}

}  // namespace

// grad_out (P, C) and grad_x (rows, C), both contiguous, of one dtype:
// 0 f32, 1 bf16, 2 f64.  order (P,) int32: source rows sorted by
// destination, ascending within one; offsets (rows + 1,) int32.  Every row
// of grad_x is written (0 where it has no source).
extern "C" int s4g_gather_backward(const void* grad_out, const int* order,
                                   const int* offsets, int rows, int c,
                                   int dtype, void* grad_x,
                                   cudaStream_t stream) {
  if (rows < 0 || c <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  switch (dtype) {
    case 0:
      return launch<float>(grad_out, order, offsets, rows, c, grad_x, stream);
    case 1:
      return launch<__nv_bfloat16>(grad_out, order, offsets, rows, c, grad_x,
                                   stream);
    case 2:
      return launch<double>(grad_out, order, offsets, rows, c, grad_x,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}
