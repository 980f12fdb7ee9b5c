// Gripper collision counts (K5).
//
// Replaces the TPU kernel s4g_tpu/ops/pallas/collision_kernels.py::
// _collision_kernel (wrapper collision_counts_pallas, pallas_call at
// collision_kernels.py:112).  Every valid point is moved into every
// gripper's frame (x = ((px*r00 + py*r01) + pz*r02) + r03, rounded in that
// order, no FMA) and counted in the back-hand box and the two finger boxes;
// the thresholds are applied by the caller.  Counts are integers, converted
// to f32 once (exact below 2^24, and rounded as the twin's int64 -> f32
// beyond).
//
// What bounds it on this card: operations — G x N pairs (67 M at 1,024
// poses x 65,536 rows), ~30 f32 operations and compares each if every pair
// is transformed in full, against 1 MB of points.  The count only needs the
// rare pairs inside the gripper's boxes, and z alone decides most of them:
// |z| < HALF_HAND_THICKNESS is a 2.4 cm slab.  So the work the counts need
// is ~8 operations a pair (the z row and its test) and ~22 more for each
// pair inside the slab (chip_smoke.py's bound counts these on its data).
// Design, for Hopper:
// * a block takes 512 consecutive cloud rows (128 threads, four rows each,
//   as float4 (x, y, z, valid) in registers) and a group of poses, whose
//   3x4 matrices it stages in shared memory; the launcher splits the poses
//   into as many groups as give at least 8 blocks per SM (the SM count read
//   from the card), so 1,024 poses x 65,536 rows run 1,152 blocks on 132
//   SMs (4 or 2 a SM ran slower on an H100);
// * a warp walks the group's poses, four at a time; for each it computes z
//   for its 128 rows first (one broadcast 16-byte shared load of the
//   matrix row) and takes the rows inside the z slab by ballot.  Where
//   there is none (rows from a depth camera arrive in raster order, so a
//   warp's rows often lie together) the pose costs nothing more;
// * the rows inside the slab, a few of the 128 on a tabletop, are queued
//   with their pose in a ring in shared memory, compacted by ballot rank,
//   and tested in full (x, y, the boxes) 32 at a time, one a lane: the
//   x/y work runs on full warps whatever the rows' order.  Skipped pairs
//   would count 0, so no bit changes.  A hit adds 1 to its pose's counter
//   in shared memory;
// * each block then adds its non-zero counters to an int32 scratch with
//   atomicAdd (integer sums, exact in any order), and the last block to
//   finish converts the totals to the f32 outputs.  One launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                     // rows a thread holds
constexpr int kRowsPerBlock = kThreads * kRows;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxGroup = 2048;   // poses a block stages (96 KB + counters)
constexpr int kUnroll = 4;        // poses whose z tests a warp overlaps
constexpr int kQueue = 256;       // a warp's queue: >= 32 + 128 - 1 entries
static_assert((kQueue & (kQueue - 1)) == 0 && kQueue >= 32 + kRows * 32,
              "a power of two that holds a pose's rows beside a partial pass");

struct Box {
  float finger_length, bottom_length, half_hand_thickness;
  float half_bottom_width, half_bottom_space, back_margin;
};

// One row of the transform, rounded op by op as the twin computes it.
__device__ __forceinline__ float row(const float4& p, const float4& m) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p.x, m.x),
                                       __fmul_rn(p.y, m.y)),
                             __fmul_rn(p.z, m.z)),
                   m.w);
}

__global__ void __launch_bounds__(kThreads)
collision_counts_kernel(const float4* __restrict__ mats,
                        const float4* __restrict__ cloud, int g, int n,
                        int group, Box box, int* __restrict__ acc,
                        float* __restrict__ back_out,
                        float* __restrict__ finger_out) {
  extern __shared__ float4 smem[];
  float4* mx = smem;                 // matrix rows 0, 1, 2 of each pose
  float4* my = mx + group;
  float4* mz = my + group;
  float4* queues = mz + group;       // kQueue entries a warp
  int* sback = reinterpret_cast<int*>(queues + kWarps * kQueue);
  int* sfing = sback + group;
  const int p0 = blockIdx.y * group;
  const int np = min(group, g - p0);
  for (int i = threadIdx.x; i < np; i += kThreads) {
    mx[i] = __ldg(mats + 4 * (p0 + i));
    my[i] = __ldg(mats + 4 * (p0 + i) + 1);
    mz[i] = __ldg(mats + 4 * (p0 + i) + 2);
    sback[i] = sfing[i] = 0;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1;   // lanes under this one
  const int r0 = blockIdx.x * kRowsPerBlock + warp * kRows * 32 + lane;
  float4 pt[kRows];
  bool live[kRows], any_live = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = r0 + 32 * r;
    pt[r] = j < n ? __ldg(cloud + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    live[r] = pt[r].w > 0.5f;
    any_live |= live[r];
  }
  __syncthreads();

  // A warp whose rows are all invalid (the cloud's padding) has nothing to
  // count.
  if (__any_sync(S4G_FULL_MASK, any_live)) {
    // The warp's queue of (row inside the z slab, pose) pairs: a row's
    // x, y, z and the pose index in w.  Entries [head, tail) are pending.
    float4* wq = queues + warp * kQueue;
    int head = 0, tail = 0;
    // Test `avail` (<= 32) queued pairs, one a lane, in full.
    auto drain = [&](int avail) {
      __syncwarp();
      bool hb = false, hf = false;
      int q = 0;
      if (lane < avail) {
        const float4 e = wq[(head + lane) & (kQueue - 1)];
        q = __float_as_int(e.w);
        const float x = row(e, mx[q]);
        if (x < box.finger_length && x > -box.bottom_length) {
          const float y = row(e, my[q]);
          hb = y < box.half_bottom_width && y > -box.half_bottom_width &&
               x < -box.back_margin;
          hf = (y < box.half_bottom_width && y > box.half_bottom_space) ||
               (y > -box.half_bottom_width && y < -box.half_bottom_space);
        }
      }
      if (hb) atomicAdd(sback + q, 1);
      if (hf) atomicAdd(sfing + q, 1);
      head += avail;
      __syncwarp();
    };
    for (int q0 = 0; q0 < np; q0 += kUnroll) {
      unsigned in_z[kUnroll][kRows];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 m = mz[min(q0 + u, np - 1)];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          in_z[u][r] = __ballot_sync(
              S4G_FULL_MASK, live[r] && q0 + u < np &&
                                 fabsf(row(pt[r], m)) <
                                     box.half_hand_thickness);
      }
      // Queue each pose's rows inside the slab, compacted by ballot rank.
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float qf = __int_as_float(q0 + u);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (in_z[u][r] >> lane & 1)
            wq[(tail + __popc(in_z[u][r] & below)) & (kQueue - 1)] =
                make_float4(pt[r].x, pt[r].y, pt[r].z, qf);
          tail += __popc(in_z[u][r]);
        }
        while (tail - head >= 32) drain(32);
      }
    }
    while (tail > head) drain(min(32, tail - head));
  }

  __syncthreads();

  for (int i = threadIdx.x; i < np; i += kThreads) {
    if (sback[i]) atomicAdd(acc + p0 + i, sback[i]);
    if (sfing[i]) atomicAdd(acc + g + p0 + i, sfing[i]);
  }
  // The last block to finish converts the totals (threadFenceReduction).
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned done = atomicAdd(reinterpret_cast<unsigned*>(acc + 2 * g),
                                    1u);
    last = done == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < g; i += kThreads) {
    back_out[i] = static_cast<float>(__ldcg(acc + i));
    finger_out[i] = static_cast<float>(__ldcg(acc + g + i));
  }
}

}  // namespace

// mats (G, 4, 4) f32 world->gripper matrices; cloud_valid (N, 4) f32 rows
// (x, y, z, valid); acc (2G + 1) int32, zeroed by the caller; back, finger
// (G,) f32.

extern "C" int s4g_collision_counts(const float* mats, const float* cloud_valid,
                                    int g, int n, float finger_length,
                                    float bottom_length,
                                    float half_hand_thickness,
                                    float half_bottom_width,
                                    float half_bottom_space, float back_margin,
                                    int* acc, float* back, float* finger,
                                    cudaStream_t stream) {
  if (g < 1 || n < 1) return cudaErrorInvalidValue;
  const Box box{finger_length, bottom_length, half_hand_thickness,
                half_bottom_width, half_bottom_space, back_margin};
  int sms = 0;
  cudaError_t err = s4g_sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int chunks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  // As many pose groups as give kBlocksPerSm blocks per SM, and groups of
  // at most kMaxGroup poses.
  int groups = (kBlocksPerSm * sms + chunks - 1) / chunks;
  groups = max(groups, (g + kMaxGroup - 1) / kMaxGroup);
  groups = min(groups, g);
  int group = (g + groups - 1) / groups;
  group = (group + kUnroll - 1) / kUnroll * kUnroll;
  groups = (g + group - 1) / group;
  const size_t smem =
      static_cast<size_t>(group) * (3 * sizeof(float4) + 2 * sizeof(int)) +
      kWarps * kQueue * sizeof(float4);
  static size_t granted = 0;
  err = s4g_allow_smem(collision_counts_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(chunks, groups);
  collision_counts_kernel<<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(mats),
      reinterpret_cast<const float4*>(cloud_valid), g, n, group, box, acc,
      back, finger);
  return cudaGetLastError();
}
