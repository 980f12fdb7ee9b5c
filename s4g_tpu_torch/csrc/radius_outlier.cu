// Radius-outlier neighbour counts (K9).
//
// Replaces no TPU kernel.  The JAX package runs the radius-outlier test of
// preprocessing (s4g_tpu/pipeline/preprocessing.py, radius_outlier_mask) as
// XLA matmul chunks, and the port's first route copied that shape: for each
// 1,024-row chunk of a 65,536-row scene, a (1,024 x 65,536) f32 distance
// matrix written and read back about six times, ~450 launches a scene.
// This kernel counts, for every valid query, the valid keys within the
// radius (itself included); keep = valid & (count >= min_neighbors).
//
// The distance is the matmul form, in f32, every operation rounded on its
// own (the _rn intrinsics: nvcc contracts none of them into an FMA):
//   |p|^2 = (x*x + y*y) + z*z,  q.k = (q0*k0 + q1*k1) + q2*k2,
//   d = (|q|^2 + |k|^2) - 2*(q.k),  a neighbour when d < r2.
// cuBLAS does not document how it rounds the old route's K = 3 product;
// this rounding is the kernel's, and its plain twin
// (ops/neighbors.py::_radius_outlier_counts_plain) evaluates the same.
//
// What bounds it on this card: operations, ~9 f32 operations per (valid
// query, valid key) pair (5 for q.k, 3 for d, the compare) against 12 bytes
// a row.  A voxelised 65,536-row scene holds fewer valid rows, as a prefix
// (~40 k for a 640 x 480 frame of a table), so the work is valid x valid,
// not capacity x capacity.  Design, for Hopper:
// * a block takes kTileQ = 512 queries (128 threads, four each, in
//   registers with their |q|^2) and one tile of kTileK = 1,024 keys, staged
//   in shared memory as float4 (x, y, z, |k|^2); an invalid key (and the
//   ragged tail past N) gets |k|^2 = +inf, so the valid test folds into the
//   compare: inf, and the NaN of inf - inf, are never < r2;
// * the grid is (key tiles x query tiles), 64 x 128 blocks at 65,536 rows,
//   of which a 40 k-row valid prefix keeps ~3,100 busy on the 132 SMs.  A
//   block whose queries, or whose keys, are all invalid exits after one
//   __syncthreads_or, so the work follows the valid count the card sees
//   and nothing is read on the host;
// * each block adds its queries' partial counts to the (N,) int32 totals
//   with atomicAdd (integer sums: the same in any order), and a second
//   kernel writes keep.  One call, two launches, no host synchronisation.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 4;                         // queries per thread
constexpr int kTileQ = kThreads * kQ;         // queries per block
constexpr int kTileK = 1024;                  // keys per block (16 KB)
constexpr int kKeysPerThread = kTileK / kThreads;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kThreads)
radius_outlier_count_kernel(const float* __restrict__ points,
                            const unsigned char* __restrict__ valid, int n,
                            float r2, int* __restrict__ counts) {
  __shared__ float4 sk[kTileK];
  const int k0 = blockIdx.x * kTileK;
  const int q0 = blockIdx.y * kTileQ + threadIdx.x;

  float qx[kQ], qy[kQ], qz[kQ], qs[kQ];
  bool active[kQ];
  bool any_query = false;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = q0 + q * kThreads;
    active[q] = i < n && valid[i];
    any_query |= active[q];
    qx[q] = active[q] ? points[3 * static_cast<size_t>(i)] : 0.f;
    qy[q] = active[q] ? points[3 * static_cast<size_t>(i) + 1] : 0.f;
    qz[q] = active[q] ? points[3 * static_cast<size_t>(i) + 2] : 0.f;
    qs[q] = sq_norm(qx[q], qy[q], qz[q]);
  }
  if (!__syncthreads_or(any_query)) return;

  bool any_key = false;
#pragma unroll
  for (int s = 0; s < kKeysPerThread; ++s) {
    const int t = threadIdx.x + s * kThreads;
    const int j = k0 + t;
    float4 k = make_float4(0.f, 0.f, 0.f, INFINITY);
    if (j < n && valid[j]) {
      const size_t o = 3 * static_cast<size_t>(j);
      k = make_float4(points[o], points[o + 1], points[o + 2], 0.f);
      k.w = sq_norm(k.x, k.y, k.z);
      any_key = true;
    }
    sk[t] = k;
  }
  if (!__syncthreads_or(any_key)) return;   // also the staging barrier

  int cnt[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) cnt[q] = 0;
#pragma unroll 8
  for (int t = 0; t < kTileK; ++t) {
    const float4 k = sk[t];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float dot = __fadd_rn(
          __fadd_rn(__fmul_rn(qx[q], k.x), __fmul_rn(qy[q], k.y)),
          __fmul_rn(qz[q], k.z));
      const float d = __fsub_rn(__fadd_rn(qs[q], k.w), __fmul_rn(2.f, dot));
      cnt[q] += d < r2;
    }
  }

#pragma unroll
  for (int q = 0; q < kQ; ++q)
    if (active[q] && cnt[q] > 0)
      atomicAdd(counts + q0 + q * kThreads, cnt[q]);
}

__global__ void __launch_bounds__(256)
radius_outlier_keep_kernel(const unsigned char* __restrict__ valid,
                           const int* __restrict__ counts, int n,
                           int min_neighbors, bool* __restrict__ keep) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n) keep[i] = valid[i] && counts[i] >= min_neighbors;
}

}  // namespace

// points (N, 3) f32; valid (N,) bool; counts (N,) int32, written (0 for an
// invalid row); keep (N,) bool.  Both launches belong to one call.
extern "C" int s4g_radius_outlier(const float* points,
                                  const unsigned char* valid, int n, float r2,
                                  int min_neighbors, int* counts, bool* keep,
                                  cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const int qtiles = (n + kTileQ - 1) / kTileQ;
  if (qtiles > 65535) return cudaErrorInvalidValue;   // grid.y's limit
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * n, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTileK - 1) / kTileK, qtiles);
  radius_outlier_count_kernel<<<grid, kThreads, 0, stream>>>(
      points, valid, n, r2, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  radius_outlier_keep_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      valid, counts, n, min_neighbors, keep);
  return cudaGetLastError();
}
