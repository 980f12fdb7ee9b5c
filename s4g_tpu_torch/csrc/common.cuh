// Shared helpers of the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define S4G_FULL_MASK 0xffffffffu

// Squared distance in f32 difference form, rounded after every operation:
// ((dx*dx) + (dy*dy)) + (dz*dz) with d = a - b.  The _rn intrinsics keep
// nvcc from contracting a*b+c into an FMA, so the result is bit-identical
// to the plain PyTorch twin and to the JAX reference (a strict `<` at the
// ball radius, FPS near-ties and 3-NN ties all depend on the last bit).
__device__ __forceinline__ float s4g_sqdist(float ax, float ay, float az,
                                            float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.  Raised
// only when a launch needs more than before, so steady-state launches (and
// CUDA-graph captures) make no attribute call.
template <typename Kernel>
__host__ inline cudaError_t s4g_allow_smem(Kernel kernel, size_t bytes,
                                           size_t* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *granted = bytes;
  return err;
}
