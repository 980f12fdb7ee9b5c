// 128-shard farthest point sampling (K1): per stage, and nested over the
// SA stages.
//
// Replaces the TPU kernel s4g_tpu/ops/sampling.py::_fps_lane_kernel
// (wrapper _fps_lane_sharded_pallas, pallas_call at sampling.py:353).
// Shard g of a scene is the contiguous point range [g*Ns, (g+1)*Ns),
// Ns = N/128.  Each shard runs exact FPS for M/128 centroids: it starts at
// its local row 0, relaxes the min-distance field with f32 difference-form
// squared distances and takes the argmax, ties to the lowest row.  Output is
// shard-major global indices, (B, 128 * M/128).
//
// What bounds it on this card: neither bytes (12 B per point, read once)
// nor operations (~10 flops per point per iteration) — it is a chain of
// M/128 dependent argmax steps per shard, i.e. latency.
//
// Per-stage kernel (any Ns): one warp per (scene, shard); each step is a
// pass over the shard's shared-memory points plus a 5-level shuffle
// argmax, with no block barrier inside the loop.
//
// Nested kernel (Ns <= 32 * kNestPerLane): the SA stages of a sorted
// forward, all in one launch.  With sort_local, stage s + 1's shard g is
// exactly stage s's shard-g picks in ascending row order, so one warp per
// (scene, shard) runs every stage (deployed: 200 -> 40 -> 8 -> 2 points):
// the shard's points and min-distances live in registers (lane l holds rows
// l + 32 i), a step is one register pass (compiled for the stage's number
// of register slots, so it holds no per-slot branch) and two warp reductions
// (__reduce_max_sync over the f32 bits of the non-negative distance, then
// __reduce_min_sync over the rows that hold it: lowest-row ties), and the
// winner's coordinates are one broadcast read of the stage's rows, kept in
// shared memory in row order beside the registers.  Between stages a
// ballot per register slot ranks the picked rows by row, which is
// sort_local; the picks are written out at those ranks and handed to the
// next stage through shared memory.  Stage s's output indexes stage s-1's
// picks (stage 1: the cloud), as the per-stage route's does after
// sort_local.  Once every row is at distance 0 from the picks, the argmax
// is row 0 again (it is the lowest row at 0): those repeats are counted and
// lead the sorted picks, as torch.sort puts them.

#include "common.cuh"

namespace {

constexpr int kShards = 128;
constexpr int kNestPerLane = 8;        // rows per lane: shards of <= 256
constexpr int kMaxStages = 3;

__global__ void fps_lane_kernel(const float* __restrict__ pts, int n, int ns,
                                int m_g, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + ns;
  float* sz = sy + ns;
  float* md = sz + ns;

  const int shard = blockIdx.x;
  const int num_shards = gridDim.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  const int off = shard * ns;
  const float* px = pts + static_cast<size_t>(b) * 3 * n + off;

  for (int j = lane; j < ns; j += 32) {
    sx[j] = px[j];
    sy[j] = px[n + j];
    sz[j] = px[2 * n + j];
    md[j] = INFINITY;
  }
  __syncwarp();

  int* o = out + (static_cast<size_t>(b) * num_shards + shard) * m_g;
  if (lane == 0) o[0] = off;
  int cur = 0;
  for (int i = 1; i < m_g; ++i) {
    const float cx = sx[cur], cy = sy[cur], cz = sz[cur];
    float best = -INFINITY;
    int best_j = 0x7fffffff;
    for (int j = lane; j < ns; j += 32) {
      const float d = s4g_sqdist(sx[j], sy[j], sz[j], cx, cy, cz);
      const float v = fminf(md[j], d);
      md[j] = v;
      if (v > best) {  // ascending j: strict > keeps the lowest row
        best = v;
        best_j = j;
      }
    }
    for (int s = 16; s > 0; s >>= 1) {
      const float ob = __shfl_xor_sync(S4G_FULL_MASK, best, s);
      const int oj = __shfl_xor_sync(S4G_FULL_MASK, best_j, s);
      if (ob > best || (ob == best && oj < best_j)) {
        best = ob;
        best_j = oj;
      }
    }
    cur = best_j;
    if (lane == 0) o[i] = off + cur;
  }
}

struct Nest {
  int stages;
  int ns[kMaxStages];        // points per shard at stage s's input
  int mg[kMaxStages];        // picks per shard at stage s
  int* out[kMaxStages];      // (B, 128 * mg[s]) int32
};

// One stage's argmax steps on rows held in S register slots (compile-time,
// so the pass has no per-slot branch).  md >= +0, so its f32 bits order as
// the values: each lane takes its lowest row at its max (ascending rows,
// strict >), one reduction the warp's max, another the lowest row holding
// it; the winner's coordinates are a broadcast read of the stage's rows.
// Rows past the stage sit at distance 0 and never beat a real row.
template <int S>
__device__ __forceinline__ void nested_steps(
    const float (&x)[kNestPerLane], const float (&y)[kNestPerLane],
    const float (&z)[kNestPerLane], float (&md)[kNestPerLane], int mg,
    const float* sx, const float* sy, const float* sz, unsigned& picked,
    int& repeats) {
  const unsigned lane = threadIdx.x;
  float cx = sx[0], cy = sy[0], cz = sz[0];
  for (int step = 1; step < mg; ++step) {
    unsigned best = 0, best_j = lane;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      md[i] = fminf(md[i], s4g_sqdist(x[i], y[i], z[i], cx, cy, cz));
      const unsigned bits = __float_as_uint(md[i]);
      if (i == 0 || bits > best) {
        best = bits;
        best_j = lane + 32 * i;
      }
    }
    const unsigned top = __reduce_max_sync(S4G_FULL_MASK, best);
    const unsigned win =
        __reduce_min_sync(S4G_FULL_MASK, best == top ? best_j : ~0u);
    cx = sx[win];
    cy = sy[win];
    cz = sz[win];
    if (top == 0) ++repeats;   // every row at 0: row 0 again
    if (lane == (win & 31)) picked |= 1u << (win >> 5);
  }
}

// nested_steps<S> for S = the stage's slots (S0 <= slots <= kNestPerLane).
template <int S0>
__device__ __forceinline__ void nested_stage(
    int slots, const float (&x)[kNestPerLane], const float (&y)[kNestPerLane],
    const float (&z)[kNestPerLane], float (&md)[kNestPerLane], int mg,
    const float* sx, const float* sy, const float* sz, unsigned& picked,
    int& repeats) {
  if constexpr (S0 < kNestPerLane) {
    if (slots > S0)
      return nested_stage<S0 + 1>(slots, x, y, z, md, mg, sx, sy, sz, picked,
                                  repeats);
  }
  nested_steps<S0>(x, y, z, md, mg, sx, sy, sz, picked, repeats);
}

__global__ void __launch_bounds__(32)
fps_nested_kernel(const float* __restrict__ pts, int n, Nest nest) {
  constexpr int P = kNestPerLane;
  __shared__ float sx[32 * P], sy[32 * P], sz[32 * P];
  const int shard = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1;   // lanes under this one

  // The stage's rows live in registers (lane l: rows l + 32 i) and, for the
  // winner's coordinates, in shared memory in row order.
  float x[P], y[P], z[P], md[P];
  int ns = nest.ns[0];
  const float* px =
      pts + static_cast<size_t>(b) * 3 * n + static_cast<size_t>(shard) * ns;
  for (int j = lane; j < ns; j += 32) {
    sx[j] = __ldg(px + j);
    sy[j] = __ldg(px + n + j);
    sz[j] = __ldg(px + 2 * n + j);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = lane + 32 * i;
    x[i] = j < ns ? sx[j] : 0.f;
    y[i] = j < ns ? sy[j] : 0.f;
    z[i] = j < ns ? sz[j] : 0.f;
  }

  for (int s = 0; s < nest.stages; ++s) {
    const int mg = nest.mg[s];
    const int slots = (ns + 31) / 32;
#pragma unroll
    for (int i = 0; i < P; ++i) md[i] = lane + 32 * i < ns ? INFINITY : 0.f;
    unsigned picked = lane == 0 ? 1u : 0u;   // bit i: row lane + 32 i
    int repeats = 0;                         // extra picks of row 0
    nested_stage<1>(slots, x, y, z, md, mg, sx, sy, sz, picked, repeats);

    // sort_local: rank the picked rows by row; row 0 and its repeats lead.
    int* o = nest.out[s] + (static_cast<size_t>(b) * kShards + shard) * mg;
    const int off = shard * ns;
    int rank = repeats;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i < slots) {
        const bool mine = (picked >> i) & 1;
        const unsigned ballot = __ballot_sync(S4G_FULL_MASK, mine);
        if (mine) {
          const int r = rank + __popc(ballot & below);
          const int lo = (i == 0 && lane == 0) ? 0 : r;   // row 0: 0..repeats
          for (int q = lo; q <= r; ++q) {
            o[q] = off + lane + 32 * i;
            sx[q] = x[i];
            sy[q] = y[i];
            sz[q] = z[i];
          }
        }
        rank += __popc(ballot);
      }
    }
    __syncwarp();
    ns = mg;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int j = lane + 32 * i;
      x[i] = j < ns ? sx[j] : 0.f;
      y[i] = j < ns ? sy[j] : 0.f;
      z[i] = j < ns ? sz[j] : 0.f;
    }
    __syncwarp();
  }
}

}  // namespace

// pts (B, 3, N) f32.  nested == 0: one stage on the per-stage kernel, m0
// centroids into out0.  nested = S in 1..3: S stages on the nested kernel,
// m_s centroids of stage s into out_s (stage 1 indexes the cloud, stage
// s > 1 stage s-1's picks).  Every stage needs 128 | its input and its M,
// M >= 128 and input >= M; the nested kernel shards of at most 256 points.
// Refuses the rest (cudaErrorInvalidValue).
extern "C" int s4g_fps_lane(const float* pts, int b, int n, int nested,
                            int m0, int m1, int m2, int* out0, int* out1,
                            int* out2, cudaStream_t stream) {
  const int ms[kMaxStages] = {m0, m1, m2};
  int* outs[kMaxStages] = {out0, out1, out2};
  const int stages = nested == 0 ? 1 : nested;
  if (b < 1 || nested < 0 || nested > kMaxStages) return cudaErrorInvalidValue;
  int input = n;
  for (int s = 0; s < stages; ++s) {
    if (input % kShards || ms[s] % kShards || ms[s] < kShards ||
        ms[s] > input || !outs[s])
      return cudaErrorInvalidValue;
    input = ms[s];
  }
  if (nested == 0) {
    const int ns = n / kShards;
    const size_t smem = 4 * sizeof(float) * static_cast<size_t>(ns);
    static size_t granted = 0;
    cudaError_t err = s4g_allow_smem(fps_lane_kernel, smem, &granted);
    if (err != cudaSuccess) return err;
    fps_lane_kernel<<<dim3(kShards, b), 32, smem, stream>>>(
        pts, n, ns, m0 / kShards, out0);
    return cudaGetLastError();
  }
  if (n / kShards > 32 * kNestPerLane) return cudaErrorInvalidValue;
  Nest nest;
  nest.stages = stages;
  input = n;
  for (int s = 0; s < kMaxStages; ++s) {
    nest.ns[s] = s < stages ? input / kShards : 0;
    nest.mg[s] = s < stages ? ms[s] / kShards : 0;
    nest.out[s] = s < stages ? outs[s] : nullptr;
    if (s < stages) input = ms[s];
  }
  fps_nested_kernel<<<dim3(kShards, b), 32, 0, stream>>>(pts, n, nest);
  return cudaGetLastError();
}
