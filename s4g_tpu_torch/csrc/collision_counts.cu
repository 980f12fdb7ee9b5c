// Gripper collision counts (K5).
//
// Replaces the TPU kernel s4g_tpu/ops/pallas/collision_kernels.py::
// _collision_kernel (wrapper collision_counts_pallas, pallas_call at
// collision_kernels.py:112).  Every point is moved into every gripper's
// frame (x = px*r00 + py*r01 + pz*r02 + r03, rounded in that order) and
// counted in the back-hand box and the two finger boxes; the thresholds are
// applied by the caller.
//
// What bounds it on this card: operations — G * N pairs (67 M at 1024 poses
// x 65,536 points, ~30 flops and compares each) against 1 MB of points.
// Design: a block takes 8 poses, keeps their 3x4 matrices in registers and
// streams the cloud once as float4 (x, y, z, valid), so each point load
// serves 8 poses.  Counts are integers reduced in the block (warp shuffles,
// then shared memory) and written once: no float atomics, so the result is
// deterministic.

#include "common.cuh"

namespace {

constexpr int kPoses = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Box {
  float finger_length, bottom_length, half_hand_thickness;
  float half_bottom_width, half_bottom_space, back_margin;
};

__global__ void __launch_bounds__(kThreads)
collision_counts_kernel(const float* __restrict__ mats,
                        const float4* __restrict__ cloud, int g, int n,
                        Box box, float* __restrict__ back_out,
                        float* __restrict__ finger_out) {
  __shared__ int red[kWarps][2 * kPoses];
  const int p0 = blockIdx.x * kPoses;
  float r[kPoses][12];
#pragma unroll
  for (int p = 0; p < kPoses; ++p)
#pragma unroll
    for (int e = 0; e < 12; ++e)
      r[p][e] = p0 + p < g ? mats[(p0 + p) * 16 + e] : 0.f;

  int back[kPoses], finger[kPoses];
#pragma unroll
  for (int p = 0; p < kPoses; ++p) back[p] = finger[p] = 0;

  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float4 pt = cloud[j];
    if (!(pt.w > 0.5f)) continue;
#pragma unroll
    for (int p = 0; p < kPoses; ++p) {
      const float* m = r[p];
      const float x = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(pt.x, m[0]),
                                                    __fmul_rn(pt.y, m[1])),
                                          __fmul_rn(pt.z, m[2])), m[3]);
      const float y = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(pt.x, m[4]),
                                                    __fmul_rn(pt.y, m[5])),
                                          __fmul_rn(pt.z, m[6])), m[7]);
      const float z = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(pt.x, m[8]),
                                                    __fmul_rn(pt.y, m[9])),
                                          __fmul_rn(pt.z, m[10])), m[11]);
      const bool base = x < box.finger_length && x > -box.bottom_length &&
                        z < box.half_hand_thickness &&
                        z > -box.half_hand_thickness;
      back[p] += base && y < box.half_bottom_width &&
                 y > -box.half_bottom_width && x < -box.back_margin;
      finger[p] += base && ((y < box.half_bottom_width &&
                             y > box.half_bottom_space) ||
                            (y > -box.half_bottom_width &&
                             y < -box.half_bottom_space));
    }
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int p = 0; p < kPoses; ++p) {
    int bc = back[p], fc = finger[p];
    for (int s = 16; s > 0; s >>= 1) {
      bc += __shfl_xor_sync(S4G_FULL_MASK, bc, s);
      fc += __shfl_xor_sync(S4G_FULL_MASK, fc, s);
    }
    if (lane == 0) {
      red[warp][p] = bc;
      red[warp][kPoses + p] = fc;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kPoses) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += red[w][threadIdx.x];
    const int p = threadIdx.x % kPoses;
    if (p0 + p < g) {
      float* out = threadIdx.x < kPoses ? back_out : finger_out;
      out[p0 + p] = static_cast<float>(total);
    }
  }
}

}  // namespace

extern "C" int s4g_collision_counts(const float* mats, const float* cloud_valid,
                                    int g, int n, float finger_length,
                                    float bottom_length,
                                    float half_hand_thickness,
                                    float half_bottom_width,
                                    float half_bottom_space, float back_margin,
                                    float* back, float* finger,
                                    cudaStream_t stream) {
  const Box box{finger_length, bottom_length, half_hand_thickness,
                half_bottom_width, half_bottom_space, back_margin};
  const int blocks = (g + kPoses - 1) / kPoses;
  collision_counts_kernel<<<blocks, kThreads, 0, stream>>>(
      mats, reinterpret_cast<const float4*>(cloud_valid), g, n, box, back,
      finger);
  return cudaGetLastError();
}
