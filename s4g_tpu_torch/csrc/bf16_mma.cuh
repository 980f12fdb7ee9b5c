// bf16 helpers and the m16n8k16 tensor-core product shared by the kernels
// that multiply bf16 by bf16 with f32 sums (K3, K7).
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two floats -> one bf16x2 register (lo in the low half), round to nearest.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// c += a * b for one 16x8x16 tile: a 4 regs (16x16 bf16, row major), b 2 regs
// (16x8 bf16, column major), c 4 f32.  With g = lane / 4 and t = lane % 4:
// a = {A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]},
// b = {B[2t..2t+1][g], B[2t+8..2t+9][g]},
// c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
