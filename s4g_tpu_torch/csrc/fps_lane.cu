// 128-shard farthest point sampling (K1).
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
// M/128 dependent argmax steps per shard, i.e. latency.  Design: one warp
// per (scene, shard) so each step is a register pass over the shard's
// <= 200 shared-memory points plus a 5-level shuffle argmax, with no block
// barrier inside the loop; all 128 * B chains run at once on the SMs.

#include "common.cuh"

namespace {

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

}  // namespace

extern "C" int s4g_fps_lane(const float* pts, int b, int n, int m,
                            int* out, cudaStream_t stream) {
  constexpr int kShards = 128;
  const int ns = n / kShards;
  const int m_g = m / kShards;
  const size_t smem = 4 * sizeof(float) * static_cast<size_t>(ns);
  static size_t granted = 0;
  cudaError_t err = s4g_allow_smem(fps_lane_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  fps_lane_kernel<<<dim3(kShards, b), 32, smem, stream>>>(pts, n, ns, m_g,
                                                          out);
  return cudaGetLastError();
}
