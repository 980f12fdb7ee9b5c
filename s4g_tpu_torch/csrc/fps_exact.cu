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
// over all its points and an argmax over all of them.
//
// Design: one thread-block cluster per chain, C blocks on neighbouring SMs
// (C = 1..16, the fewest that leave each block at most kTargetPoints
// points; C = 16 is a non-portable size, checked resident with
// cudaOccupancyMaxActiveClusters, else halved).  Block r owns the chain's
// points [r * S, (r + 1) * S), S = ceil(N_chain / C): their coordinates and
// min-distances in registers (PPT points a thread, up to 16 x 512 = 8,192
// a block), the coordinates also in shared memory for the winner's lookup.
// A block whose slice is longer keeps the rest of its min-distances in a
// scratch buffer the wrapper allocates (4 bytes a point), each thread its
// own points, relaxed after the register ones so that a thread still
// visits its points in ascending order; their coordinates come from shared
// memory as far as it holds them, then from L2.
// A step: relax, then the argmax of the block.  Values are non-negative f32
// (+inf before the first relax), whose bits order as u32, so a warp's
// argmax is __reduce_max_sync over the value bits and __reduce_min_sync over
// the indices of the lanes that hold the max: (largest, lowest index)
// exactly.  Warps meet in a double-buffered shared array (one barrier).
// Then the block's winner (value bits, index, coordinates) goes to every
// block of the cluster, and every block reduces the C messages to the
// chain's winner, whose coordinates are the next step's centroid.  The
// exchange pushes: one lane per peer writes the message into the peer's
// shared memory with st.async, which completes C x 20 bytes on the peer's
// mbarrier; each block waits on its own barrier.  Slots and barriers are
// double-buffered by step parity.  Two buffers suffice: a block sends step
// s only after it read step s-1's buffer (it needed that winner), and it
// read step s-2's buffer before its step s-1 barrier, so a peer a step
// ahead never overwrites a buffer still being read.  A peer's message may
// land before the block's own arrive.expect_tx for that phase; the
// barrier's tx-count then runs negative until it does.
// What is left: a step is a chain of dependent latencies (warp and block
// argmax, shared-memory hops, the push, the wait, the messages' argmax)
// after a relax that at SA1 issues ~50 instructions a thread.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPpt = 16;
constexpr int kRegPoints = kThreads * kMaxPpt;   // 8,192 a block
constexpr int kMaxCluster = 16;
constexpr int kTargetPoints = 2048;              // a block's share, at most
constexpr int kMsgWords = 8;                     // a 20-byte message, padded
constexpr int kMsgBytes = 20;
// Shared memory: 2 mbarriers, [2][kMaxCluster] message slots, [2][kWarps]
// warp winners, then the coordinate cache.
constexpr int kMsgOff = 32;
constexpr int kRedOff = kMsgOff + 2 * kMaxCluster * kMsgWords * 4;
constexpr int kCacheOff = kRedOff + 2 * kWarps * 8;
constexpr int kMaxCached =
    static_cast<int>((kS4gMaxSmem - kCacheOff) / (3 * sizeof(float)));
constexpr unsigned kNoIndex = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The address of the same shared-memory location in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(local), "r"(rank));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// (largest value bits, lowest index among the lanes that hold them) over
// the warp.
__device__ __forceinline__ void warp_argmax(unsigned& v, unsigned& j) {
  const unsigned mv = __reduce_max_sync(S4G_FULL_MASK, v);
  j = __reduce_min_sync(S4G_FULL_MASK, v == mv ? j : kNoIndex);
  v = mv;
}

template <int PPT>
__global__ void __launch_bounds__(kThreads, 1)
fps_cluster_kernel(const float* __restrict__ pts, int n, int ns, int shards,
                   int m_g, int csize, int slice, int cached,
                   float* __restrict__ spill, int spill_stride,
                   int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned* msg = reinterpret_cast<unsigned*>(smem + kMsgOff);
  uint2* red = reinterpret_cast<uint2*>(smem + kRedOff);
  float* sx = reinterpret_cast<float*>(smem + kCacheOff);
  float* sy = sx + cached;
  float* sz = sy + cached;

  const uint32_t rank = cluster_rank();
  const int chain = blockIdx.x / csize;
  const int b = chain / shards;
  const int off = (chain - b * shards) * ns;
  const float* px = pts + static_cast<size_t>(b) * 3 * n + off;
  const float* py = px + n;
  const float* pz = py + n;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  const int lo = static_cast<int>(rank) * slice;   // first point of the block
  const int cnt = max(0, min(slice, ns - lo));     // points of the block
  const int ncache = min(cnt, cached);

  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bar + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < ncache; j += nthreads) {
    sx[j] = px[lo + j];
    sy[j] = py[lo + j];
    sz[j] = pz[lo + j];
  }
  float rx[PPT], ry[PPT], rz[PPT], md[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int j = i * nthreads + tid;
    md[i] = INFINITY;
    rx[i] = ry[i] = rz[i] = 0.f;
    if (j < cnt) {
      rx[i] = px[lo + j];
      ry[i] = py[lo + j];
      rz[i] = pz[lo + j];
    }
  }
  // Points past the registers: their min-distances, each thread's own.
  const int reg_cap = PPT * nthreads;
  const int nspill = max(0, cnt - reg_cap);
  float* sp = spill + static_cast<size_t>(blockIdx.x) * spill_stride;
  for (int s = tid; s < nspill; s += nthreads) sp[s] = INFINITY;
  // Every block's barriers are initialised before any peer writes to them.
  cluster_sync();

  int* o = out + static_cast<size_t>(chain) * m_g;
  if (rank == 0 && tid == 0) o[0] = off;
  float cx = px[0], cy = py[0], cz = pz[0];
  unsigned phases = 0;   // bit i: the parity barrier i waits for next
  for (int step = 1; step < m_g; ++step) {
    float best = -INFINITY;
    int best_j = -1;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int j = i * nthreads + tid;
      if (j < cnt) {
        const float v = fminf(md[i], s4g_sqdist(rx[i], ry[i], rz[i], cx, cy,
                                                cz));
        md[i] = v;
        if (v > best) {   // ascending j: strict > keeps the lowest index
          best = v;
          best_j = j;
        }
      }
    }
    for (int s = tid; s < nspill; s += nthreads) {   // past the registers
      const int j = reg_cap + s;
      float x, y, z;
      if (j < cached) {
        x = sx[j];
        y = sy[j];
        z = sz[j];
      } else {
        x = __ldg(px + lo + j);
        y = __ldg(py + lo + j);
        z = __ldg(pz + lo + j);
      }
      const float v = fminf(sp[s], s4g_sqdist(x, y, z, cx, cy, cz));
      sp[s] = v;
      if (v > best) {
        best = v;
        best_j = j;
      }
    }
    // Values are >= 0 (or +inf), so their bits order as u32; a thread
    // without points offers (0, no index), which loses every tie.
    unsigned v = best_j >= 0 ? __float_as_uint(best) : 0u;
    unsigned jj = best_j >= 0 ? static_cast<unsigned>(lo + best_j) : kNoIndex;
    warp_argmax(v, jj);
    const int buf = step & 1;
    unsigned* slots = msg + buf * kMaxCluster * kMsgWords;
    if (lane == 0) red[buf * kWarps + warp] = make_uint2(v, jj);
    __syncthreads();
    if (warp == 0) {
      const uint2 r = lane < nwarps ? red[buf * kWarps + lane]
                                    : make_uint2(0u, kNoIndex);
      v = r.x;
      jj = r.y;
      warp_argmax(v, jj);
      float x = 0.f, y = 0.f, z = 0.f;
      if (lane == 0 && jj != kNoIndex) {
        const int l = static_cast<int>(jj) - lo;
        if (l < cached) {
          x = sx[l];
          y = sy[l];
          z = sz[l];
        } else {
          x = __ldg(px + jj);
          y = __ldg(py + jj);
          z = __ldg(pz + jj);
        }
      }
      x = __shfl_sync(S4G_FULL_MASK, x, 0);
      y = __shfl_sync(S4G_FULL_MASK, y, 0);
      z = __shfl_sync(S4G_FULL_MASK, z, 0);
      const uint32_t bar_local = smem_addr(bar + buf);
      if (lane == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                bar_local),
            "r"(csize * kMsgBytes)
            : "memory");
      if (lane < csize) {   // lane r writes block r's slot `rank`
        const uint32_t dst =
            peer_addr(smem_addr(slots + rank * kMsgWords), lane);
        const uint32_t dbar = peer_addr(bar_local, lane);
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
            "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
            "r"(v), "r"(jj), "r"(__float_as_uint(x)),
            "r"(__float_as_uint(y)), "r"(dbar)
            : "memory");
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
            "[%0], %1, [%2];\n" ::"r"(dst + 16),
            "r"(__float_as_uint(z)), "r"(dbar)
            : "memory");
      }
    }
    // The chain's winner from the C messages.
    unsigned mv = 0u, mj = kNoIndex, mx = 0u, my = 0u, mz = 0u;
    wait_parity(smem_addr(bar + buf), (phases >> buf) & 1u);
    phases ^= 1u << buf;
    if (lane < csize) {
      const uint4 m = *reinterpret_cast<const uint4*>(slots +
                                                      lane * kMsgWords);
      mv = m.x;
      mj = m.y;
      mx = m.z;
      my = m.w;
      mz = slots[lane * kMsgWords + 4];
    }
    unsigned wv = mv, wj = mj;
    warp_argmax(wv, wj);
    const unsigned hit =
        __ballot_sync(S4G_FULL_MASK, mv == wv && mj == wj);
    const int src_lane = __ffs(hit) - 1;
    cx = __uint_as_float(__shfl_sync(S4G_FULL_MASK, mx, src_lane));
    cy = __uint_as_float(__shfl_sync(S4G_FULL_MASK, my, src_lane));
    cz = __uint_as_float(__shfl_sync(S4G_FULL_MASK, mz, src_lane));
    if (rank == 0 && tid == 0) o[step] = off + static_cast<int>(wj);
  }
  // No block leaves while a peer's message may still be on its way to it.
  cluster_sync();
}

using Kernel = void (*)(const float*, int, int, int, int, int, int, int,
                        float*, int, int*);

Kernel kernel_for(int ppt) {
  switch (ppt) {
    case 1: return fps_cluster_kernel<1>;
    case 2: return fps_cluster_kernel<2>;
    case 4: return fps_cluster_kernel<4>;
    case 8: return fps_cluster_kernel<8>;
    default: return fps_cluster_kernel<16>;
  }
}

// A launch's geometry for a chain of ns points split over `csize` blocks.
struct Geometry {
  int csize, slice, ppt, threads, cached, spill_stride;
  size_t smem;
  Kernel kernel;
};

Geometry geometry(int ns, int csize) {
  Geometry g;
  g.csize = csize;
  g.slice = (ns + csize - 1) / csize;
  g.ppt = 1;
  while (g.ppt < kMaxPpt && g.slice > g.ppt * kThreads) g.ppt *= 2;
  const int per = (g.slice + g.ppt - 1) / g.ppt;
  g.threads = per >= kThreads ? kThreads : ((per + 31) / 32) * 32;
  g.cached = g.slice < kMaxCached ? g.slice : kMaxCached;
  g.spill_stride = g.slice > kRegPoints ? g.slice - kRegPoints : 0;
  g.smem = kCacheOff + 3 * sizeof(float) * g.cached;
  g.kernel = kernel_for(g.ppt);
  return g;
}

cudaLaunchConfig_t config_for(const Geometry& g, int clusters,
                              cudaLaunchAttribute* attr,
                              cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * g.csize));
  cfg.blockDim = dim3(static_cast<unsigned>(g.threads));
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(g.csize);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once per kernel instance: the shared-memory opt-in and the permission
// for clusters of 16.
cudaError_t prepare(Kernel k) {
  static Kernel done[5] = {};
  for (Kernel& d : done) {
    if (d == k) return cudaSuccess;
    if (d == nullptr) {
      cudaError_t err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kS4gMaxSmem));
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err == cudaSuccess) d = k;
      return err;
    }
  }
  return cudaSuccess;
}

// The cluster size for chains of ns points: the fewest blocks (a power of
// two up to 16) that leave each at most kTargetPoints points, halved while
// such a cluster cannot be resident.
cudaError_t plan_uncached(int ns, Geometry* out) {
  int c = 1;
  while (c < kMaxCluster && (ns + c - 1) / c > kTargetPoints) c *= 2;
  for (;; c /= 2) {
    Geometry g = geometry(ns, c);
    cudaError_t err = prepare(g.kernel);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config_for(g, 1, &attr, nullptr);
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, g.kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (active > 0 || c == 1) {
      *out = g;
      return active > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
    }
  }
}

// plan_uncached, remembered per ns for the process, so that steady-state
// launches (and CUDA-graph captures) make no occupancy query.
cudaError_t plan(int ns, Geometry* out) {
  struct Entry {
    int ns;
    Geometry g;
  };
  static Entry seen[32];
  static int used = 0;
  for (int i = 0; i < used; ++i) {
    if (seen[i].ns == ns) {
      *out = seen[i].g;
      return cudaSuccess;
    }
  }
  const cudaError_t err = plan_uncached(ns, out);
  if (err == cudaSuccess && used < 32) seen[used++] = {ns, *out};
  return err;
}

}  // namespace

// The cluster size and the scratch floats per block K6 takes for chains of
// ns points: plan[0] = blocks per chain, plan[1] = scratch floats each
// block needs past its registers (0: no scratch).
extern "C" int s4g_fps_exact_plan(int ns, int* plan_out) {
  if (ns < 1) return cudaErrorInvalidValue;
  Geometry g;
  const cudaError_t err = plan(ns, &g);
  if (err != cudaSuccess) return err;
  plan_out[0] = g.csize;
  plan_out[1] = g.spill_stride;
  return cudaSuccess;
}

// pts (B, 3, N) f32; B * shards chains of N/shards points, m_g centroids
// each; spill (B * shards * blocks per chain * plan[1]) f32 scratch where
// plan[1] > 0 (s4g_fps_exact_plan), else NULL; out (B, shards * m_g)
// int32.
extern "C" int s4g_fps_exact(const float* pts, int b, int n, int shards,
                             int m_g, float* spill, int* out,
                             cudaStream_t stream) {
  const int ns = n / shards;
  if (b < 1 || ns < 1 || m_g < 1) return cudaErrorInvalidValue;
  Geometry g;
  cudaError_t err = plan(ns, &g);
  if (err != cudaSuccess) return err;
  if ((g.spill_stride > 0) != (spill != nullptr)) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config_for(g, b * shards, &attr, stream);
  err = cudaLaunchKernelEx(&cfg, g.kernel, pts, n, ns, shards, m_g, g.csize,
                           g.slice, g.cached, spill, g.spill_stride, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
