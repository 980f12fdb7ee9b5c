// Exact farthest point sampling, whole scenes and G-shard slices (K6).
//
// Replaces the TPU kernel s4g_tpu/ops/sampling.py::_fps_kernel (body at
// sampling.py:81, pallas_calls in _fps_pallas :190 and _fps_sharded_pallas
// :270).  A chain is one scene (G = 1) or one of its G contiguous N/G-point
// slices; chain c of scene b = c / G starts at its local point 0, relaxes
// every point's min-distance to the selected set with the f32
// difference-form squared distance ((dx*dx + dy*dy) + dz*dz, rounded after
// every operation as the plain twin computes it) and picks the argmax, ties
// to the lowest index (all-zero distances pick index 0, as jnp.argmax and
// torch.argmax do).  Output is shard-major global indices (B, G * M/G):
// slot i of chain g is g * N/G + its local pick.  The TPU kernel's batch
// interleaving (`group`) and lane planes are TPU mechanism and are not
// carried over.
//
// What bounds it on this card: latency, not bytes (12 B per point, read
// once) or operations (~9 per point per step, 1.2e9 at SA1 = 0.018 ms at
// 67 TFLOP/s over all SMs).  A chain is M-1 dependent steps, each a pass
// over all its points and a block-wide argmax, so one chain lives on one
// SM and runs at that SM's issue rate plus one barrier per step.
//
// Design: one block per chain.  Each thread owns points tid, tid + T,
// tid + 2T, ... and keeps their min-distances in registers (PPT of them,
// a template parameter: up to 32 x 1,024 = 32,768 points per chain).  A
// longer chain keeps the min-distances of its points past 32,768 in a
// scratch buffer the wrapper allocates (4 bytes a point, L2-resident),
// each thread its own points, relaxed after the register ones so that a
// thread still visits its points in ascending order.
// The coordinates of the first `cached` points (as many as fit in 227 KB
// of shared memory, 19,328 points) are staged in shared memory once; the
// rest (6,272 of SA1's 25,600) are read through L2 every step.  Each step
// reduces (value, index) pairs with warp shuffles, then across warps
// through a double-buffered shared array, so a step has one barrier.
//
// Next step: a thread-block cluster per chain, with the points
// split across the cluster's SMs and the per-step argmax exchanged through
// distributed shared memory, so that a chain runs on several SMs and all
// coordinates stay on chip.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxPpt = 32;
constexpr int kRegPoints = kMaxThreads * kMaxPpt;   // 32,768
constexpr size_t kRedBytes = 2 * kMaxWarps * (sizeof(float) + sizeof(int));
constexpr int kMaxCached =
    static_cast<int>((kS4gMaxSmem - kRedBytes) / (3 * sizeof(float)));

// (v, j) <- the larger value, ties to the lower index.
__device__ __forceinline__ void argmax_merge(float& v, int& j, float ov,
                                             int oj) {
  if (ov > v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& j) {
  for (int s = 16; s > 0; s >>= 1) {
    const float ov = __shfl_xor_sync(S4G_FULL_MASK, v, s);
    const int oj = __shfl_xor_sync(S4G_FULL_MASK, j, s);
    argmax_merge(v, j, ov, oj);
  }
}

template <int PPT, bool kSpill>
__global__ void __launch_bounds__(kMaxThreads)
fps_exact_kernel(const float* __restrict__ pts, int n, int ns, int shards,
                 int m_g, int cached, float* __restrict__ spill,
                 int* __restrict__ out) {
  extern __shared__ float smem[];
  float* red_v = smem;                                      // [2][kMaxWarps]
  int* red_j = reinterpret_cast<int*>(red_v + 2 * kMaxWarps);
  float* sx = reinterpret_cast<float*>(red_j + 2 * kMaxWarps);
  float* sy = sx + cached;
  float* sz = sy + cached;

  const int chain = blockIdx.x;
  const int b = chain / shards;
  const int off = (chain - b * shards) * ns;
  const float* px = pts + static_cast<size_t>(b) * 3 * n + off;
  const float* py = px + n;
  const float* pz = py + n;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarps = nthreads / 32;

  for (int j = tid; j < cached; j += nthreads) {
    sx[j] = px[j];
    sy[j] = py[j];
    sz[j] = pz[j];
  }
  float md[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) md[i] = INFINITY;
  // Points past kRegPoints (kSpill only): their min-distances, each
  // thread's own.
  const int nspill = kSpill ? ns - kRegPoints : 0;
  float* sp = kSpill ? spill + static_cast<size_t>(chain) * nspill : spill;
  for (int j = tid; j < nspill; j += nthreads) sp[j] = INFINITY;
  __syncthreads();

  int* o = out + static_cast<size_t>(chain) * m_g;
  if (tid == 0) o[0] = off;
  int cur = 0;
  for (int step = 1; step < m_g; ++step) {
    float cx, cy, cz;
    if (cur < cached) {
      cx = sx[cur];
      cy = sy[cur];
      cz = sz[cur];
    } else {
      cx = __ldg(px + cur);
      cy = __ldg(py + cur);
      cz = __ldg(pz + cur);
    }
    float best = -INFINITY;
    int best_j = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int j = i * nthreads + tid;
      if (j < ns) {
        float x, y, z;
        if (j < cached) {
          x = sx[j];
          y = sy[j];
          z = sz[j];
        } else {
          x = __ldg(px + j);
          y = __ldg(py + j);
          z = __ldg(pz + j);
        }
        const float v = fminf(md[i], s4g_sqdist(x, y, z, cx, cy, cz));
        md[i] = v;
        if (v > best) {  // ascending j: strict > keeps the lowest index
          best = v;
          best_j = j;
        }
      }
    }
    for (int s = tid; kSpill && s < nspill; s += nthreads) {  // past regs
      const int j = kRegPoints + s;
      float x, y, z;
      if (j < cached) {
        x = sx[j];
        y = sy[j];
        z = sz[j];
      } else {
        x = __ldg(px + j);
        y = __ldg(py + j);
        z = __ldg(pz + j);
      }
      const float v = fminf(sp[s], s4g_sqdist(x, y, z, cx, cy, cz));
      sp[s] = v;
      if (v > best) {
        best = v;
        best_j = j;
      }
    }
    warp_argmax(best, best_j);
    // Double-buffered by step parity: a buffer is rewritten two steps
    // later, after the next step's barrier, when every warp has read it.
    const int buf = (step & 1) * kMaxWarps;
    if (lane == 0) {
      red_v[buf + warp] = best;
      red_j[buf + warp] = best_j;
    }
    __syncthreads();
    best = lane < nwarps ? red_v[buf + lane] : -INFINITY;
    best_j = lane < nwarps ? red_j[buf + lane] : 0x7fffffff;
    warp_argmax(best, best_j);
    cur = best_j;
    if (tid == 0) o[step] = off + cur;
  }
}

template <int PPT, bool kSpill = false>
cudaError_t launch_chains(const float* pts, int chains, int n, int ns,
                          int shards, int m_g, float* spill, int* out,
                          cudaStream_t stream) {
  const int per = (ns + PPT - 1) / PPT;
  const int threads = kSpill ? kMaxThreads : ((per + 31) / 32) * 32;
  const int cached = ns < kMaxCached ? ns : kMaxCached;
  const size_t smem = kRedBytes + 3 * sizeof(float) * cached;
  static size_t granted = 0;
  const cudaError_t err =
      s4g_allow_smem(fps_exact_kernel<PPT, kSpill>, smem, &granted);
  if (err != cudaSuccess) return err;
  fps_exact_kernel<PPT, kSpill><<<chains, threads, smem, stream>>>(
      pts, n, ns, shards, m_g, cached, spill, out);
  return cudaGetLastError();
}

}  // namespace

// pts (B, 3, N) f32; B * shards chains of N/shards points, m_g centroids
// each; spill (B * shards * (N/shards - 32,768)) f32 scratch for chains
// longer than 32,768 points, else NULL; out (B, shards * m_g) int32.
extern "C" int s4g_fps_exact(const float* pts, int b, int n, int shards,
                             int m_g, float* spill, int* out,
                             cudaStream_t stream) {
  const int ns = n / shards;
  const int chains = b * shards;
  if (ns < 1 || m_g < 1 || (ns > kRegPoints) != (spill != nullptr))
    return cudaErrorInvalidValue;
  // The fewest points per thread that keep the block within 1,024 threads.
  if (ns <= kMaxThreads * 1)
    return launch_chains<1>(pts, chains, n, ns, shards, m_g, spill, out,
                            stream);
  if (ns <= kMaxThreads * 2)
    return launch_chains<2>(pts, chains, n, ns, shards, m_g, spill, out,
                            stream);
  if (ns <= kMaxThreads * 4)
    return launch_chains<4>(pts, chains, n, ns, shards, m_g, spill, out,
                            stream);
  if (ns <= kMaxThreads * 8)
    return launch_chains<8>(pts, chains, n, ns, shards, m_g, spill, out,
                            stream);
  if (ns <= kMaxThreads * 16)
    return launch_chains<16>(pts, chains, n, ns, shards, m_g, spill, out,
                             stream);
  if (ns <= kRegPoints)
    return launch_chains<32>(pts, chains, n, ns, shards, m_g, spill, out,
                             stream);
  return launch_chains<32, true>(pts, chains, n, ns, shards, m_g, spill, out,
                                 stream);
}
