// Fused set-abstraction stage 1 (K3): slab ball query + grouping + the
// stage's 3-layer BN-folded MLP + max over the K neighbours, in one kernel.
//
// Replaces the TPU kernel s4g_tpu/ops/pallas/sa_fused_kernels.py::
// _sa1_kernel as driven by sa1_fused_slab_pallas (pallas_call at
// sa_fused_kernels.py:423).  Per centroid:
// * selection exactly as K2 (slab_select.cuh): the 8,192-key window of the
//   centroid's 512-tile, strict f32 difference-form d2 < r2, stratified
//   ranks for overfull balls, unfilled slots repeat slot 0;
// * rel = key - centroid in exact f32, then rounded to bf16;
// * layer 1: ((rx*w0 + ry*w1) + rz*w2) + b1 in f32 with bf16-rounded
//   weights, ReLU, -> bf16;
// * layers 2 and 3: bf16 x bf16 products with f32 sums on the tensor cores
//   (wgmma), + bias, ReLU; layer 2's output -> bf16, layer 3's stays f32;
// * max over the K slots; a centroid with no key in range writes zeros.
// Output (B, M, C3) f32.  The kernel holds C1 = C2 = 128 and C3 a multiple
// of 128 up to 256 (curvature_model.yaml's SA1 is 128/128/256) and K <= 128.
//
// What bounds it on this card: operations — at SA1 (M = 5,120, K = 64,
// 128/128/256) a scene needs ~32 GFLOP of bf16 products in layers 2-3
// (~33 us at 989 TFLOP/s) plus the f32 operations of layer 1 and of the
// distance tests, which on a sorted window only the keys of each ball's
// slab need, against ~5 MB of traffic.
// Design, for Hopper:
// * persistent blocks: one 384-thread block per SM walks a contiguous run
//   of the (scene, 16-centroid group) work list, so W2 and W3 are loaded
//   once per block.  The wrapper packs them once per call, in bf16 and in
//   the 128-byte-swizzled K-major layout that wgmma reads (96 KB at C3 =
//   256), and the block copies them in with cp.async, no conversion;
// * warp specialisation: warpgroup 2 selects.  It stages the key window of
//   the group's centroid tile (96 KB, cp.async, reloaded only when the tile
//   changes), finds a coordinate that ascends over the window (the sorted
//   axis), and per centroid scans, one warp each, only the words of keys
//   within 1.05 r of it along that axis (every other key is out of range,
//   so the ranks are the full scan's), then writes each slot's bf16 rel
//   into a ring of one or two group stages.  Warpgroups 0 and 1 run the
//   chain on the stage before, so selection overlaps the products; named
//   barriers hand the ring stages back and forth;
// * the chain on wgmma: each centroid's slots are padded to kpad, a power of
//   two >= 16, by repeating slot 0 (a repeat never changes the max), so a
//   64-row tile holds 64 / kpad centroids (K = 128 spans two tiles, both in
//   one warpgroup).  Layer 1 is computed straight into wgmma's register A
//   operand; layer 2 runs as two m64n64k16 halves with B = W2 from shared
//   memory, both in flight, whose accumulators are rounded to bf16 into
//   layer 3's register A operand; layer 3 runs in 64-column chunks, two in
//   flight, whose max over each centroid's rows (a reduce-scatter of
//   shuffles over the warp's 16 rows, then an integer atomicMax on the
//   non-negative floats across the 4 warps) is the pool.
// Shared memory at K <= 64: 96 KB of weights (no padding), the 96 KB
// window, 8 KB of ballot words, 8 KB of pool, 3.5 KB of W1 and biases and
// two 6 KB ring stages of bf16 rel: 230,032 bytes with the 1 KB alignment
// slack, of the 232,448 a block may take.  K = 128
// (kpad 128) keeps one 12 KB ring stage, so selection and products
// alternate there.
// What is left: on sorted tabletop scenes the chain (two warpgroups of
// m64n64k16 products, then layer 1 and the pool); on dense clutter
// columns, whose slabs hold most of the window, the selection.

#include <stdint.h>

#include "bf16_mma.cuh"
#include "slab_select.cuh"

namespace {

using s4g_slab::kCentroidTile;
using s4g_slab::kKeyTile;
using s4g_slab::kWindow;
using s4g_slab::kWords;
constexpr int kConsumers = 2;                       // MMA warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;    // + the selection one
constexpr int kGroup = 16;                          // centroids per item
static_assert(kCentroidTile % kGroup == 0,
              "a group must not straddle two centroid tiles");
constexpr int kC1 = 128;
constexpr int kC2 = 128;
constexpr int kMaxC3 = 256;
constexpr int kMaxK = 128;
constexpr int kN = 64;                // wgmma n per instruction (and chunk)
constexpr int kKSteps = kC1 / 16;
constexpr int kRowBytes = 128;        // one swizzle row: 64 bf16 of K
static_assert(kC1 == kC2 && kC1 == 2 * 64, "two 64-wide swizzle atoms of K");

// Shared memory, in bytes from a 1024-aligned base (the swizzle atoms of
// the weights must sit on 1024-byte boundaries).
constexpr int kW2Off = 0;
constexpr int kW3Off = kW2Off + kC1 * kC2 * 2;
constexpr int kWinOff = kW3Off + kC2 * kMaxC3 * 2;
constexpr int kParOff = kWinOff + 3 * 4 * kWindow;
constexpr int kParFloats = 3 * kC1 + kC1 + kC2 + kMaxC3;   // W1, b1, b2, b3
constexpr int kBallotOff = kParOff + 4 * kParFloats;
constexpr int kBallotBytes = 4 * 2 * 4 * kWords;           // 4 warps
constexpr int kPoolOff = kBallotOff + kBallotBytes;
constexpr int kPoolSlots = 4;            // centroids a 64-row tile ends
constexpr int kPoolBytes = kConsumers * kPoolSlots * kMaxC3 * 4;
constexpr int kCntOff = kPoolOff + kPoolBytes;
constexpr int kSortedOff = kCntOff + 2 * kGroup * 4;     // one int
constexpr int kRingOff = kSortedOff + 16;  // then stages x kGroup x kpad x 3
                                           // bf16

// Named barriers (0 is __syncthreads).
constexpr int kFullBar = 1;    // + stage: the ring stage holds a group
constexpr int kEmptyBar = 3;   // + stage: the consumers are done with it
constexpr int kWgBar = 5;      // + consumer warpgroup
constexpr int kSelBar = 5 + kConsumers;   // the selection warpgroup

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma descriptor of a K-major bf16 B operand in shared memory, 128-byte
// swizzle: 8-row core groups 1024 bytes apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t b_desc(const unsigned char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous product.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define S4G_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
// d (64 x 64 f32, this thread's 32) += A (64 x 16 bf16, registers) *
// B (16 x 64 bf16, shared memory, K-major).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const unsigned* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : S4G_F4(0), S4G_F4(4), S4G_F4(8), S4G_F4(12), S4G_F4(16), S4G_F4(20),
        S4G_F4(24), S4G_F4(28)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
#undef S4G_F4

// Layer 1 of one slot at one column: ReLU(((rx*w0 + ry*w1) + rz*w2) + b1),
// rounded after every operation (the weights are bf16 values, so every
// product is exact anyway).
__device__ __forceinline__ float layer1(const float* r, float w0, float w1,
                                        float w2, float b) {
  const float h = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r[0], w0), __fmul_rn(r[1], w1)),
                __fmul_rn(r[2], w2)),
      b);
  return fmaxf(h, 0.f);
}

// Layer 1 at columns col and col + 1 (col even) of rows a and b, packed to
// bf16 pairs: the A-fragment registers of those rows.  One 8-byte load per
// weight row and the bias.
__device__ __forceinline__ void layer1_pair(const float* ra, const float* rb,
                                            const float* w1s,
                                            const float* b1s, int col,
                                            unsigned& pa, unsigned& pb) {
  const float2 w0 = *reinterpret_cast<const float2*>(w1s + col);
  const float2 w1 = *reinterpret_cast<const float2*>(w1s + kC1 + col);
  const float2 w2 = *reinterpret_cast<const float2*>(w1s + 2 * kC1 + col);
  const float2 b = *reinterpret_cast<const float2*>(b1s + col);
  pa = pack_bf16(layer1(ra, w0.x, w1.x, w2.x, b.x),
                 layer1(ra, w0.y, w1.y, w2.y, b.y));
  pb = pack_bf16(layer1(rb, w0.x, w1.x, w2.x, b.x),
                 layer1(rb, w0.y, w1.y, w2.y, b.y));
}

// Max over the 8 row groups g (lanes xor 4, 8, 16) of v[2j + c], c in
// {0, 1}, for the 8 n-tiles j, as a reduce-scatter: each round keeps the
// half of the values whose n-tile agrees with one bit of g and trades the
// other half, so lane (g, t) ends with n-tile g's two columns, out[0..1],
// after 14 shuffles (not 48).
__device__ __forceinline__ void rowmax_scatter(const float (&v)[16], int g,
                                               float (&out)[2]) {
  float w[8], x[4];
  const bool hi4 = g & 4, hi2 = g & 2, hi1 = g & 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float send = hi4 ? v[i] : v[i + 8];
    const float keep = hi4 ? v[i + 8] : v[i];
    w[i] = fmaxf(keep, __shfl_xor_sync(S4G_FULL_MASK, send, 16));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = hi2 ? w[i] : w[i + 4];
    const float keep = hi2 ? w[i + 4] : w[i];
    x[i] = fmaxf(keep, __shfl_xor_sync(S4G_FULL_MASK, send, 8));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = hi1 ? x[i] : x[i + 2];
    const float keep = hi1 ? x[i + 2] : x[i];
    out[i] = fmaxf(keep, __shfl_xor_sync(S4G_FULL_MASK, send, 4));
  }
}

// The selection warpgroup stages the key window [base, base + kWindow) of
// scene P with 4-byte cp.async copies, all in flight at once; keys past N
// are padding (1e9, never in range).
__device__ __forceinline__ void load_window_async(const float* __restrict__ P,
                                                  int n, int base, float* kx,
                                                  float* ky, float* kz,
                                                  int tid) {
  for (int j = tid; j < kWindow; j += 128) {
    const int g = base + j;
    if (g < n) {
      float* dst[3] = {kx + j, ky + j, kz + j};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const uint32_t d =
            static_cast<uint32_t>(__cvta_generic_to_shared(dst[a]));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                     "l"(P + a * static_cast<size_t>(n) + g)
                     : "memory");
      }
    } else {
      kx[j] = ky[j] = kz[j] = 1e9f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Work {
  int b, c0, nc;
};

__device__ __forceinline__ Work work_item(int g, int gps, int m) {
  Work w;
  w.b = g / gps;
  w.c0 = (g % gps) * kGroup;
  w.nc = min(kGroup, m - w.c0);
  return w;
}

// The last warpgroup: selection into the ring.
__device__ __forceinline__ void select_groups(
    unsigned char* smem, const float* __restrict__ pts,
    const float* __restrict__ cents, const int* __restrict__ lo_tile, int n,
    int m, int ntile, float r2, int k, int kpad, int stratified, int stages,
    int gps, int g_lo, int ngroups) {
  const int tid = threadIdx.x - kConsumers * 128;
  const int warp = tid / 32, lane = tid % 32;
  float* kx = reinterpret_cast<float*>(smem + kWinOff);
  float* ky = kx + kWindow;
  float* kz = ky + kWindow;
  unsigned* words =
      reinterpret_cast<unsigned*>(smem + kBallotOff) + warp * 2 * kWords;
  int* prefix = reinterpret_cast<int*>(words + kWords);
  int* sorted = reinterpret_cast<int*>(smem + kSortedOff);
  int loaded = -1, axis = -1;
  const float* ka = kx;
  for (int gi = 0; gi < ngroups; ++gi) {
    const Work w = work_item(g_lo + gi, gps, m);
    const int tile = w.b * ntile + w.c0 / kCentroidTile;
    if (tile != loaded) {   // uniform over the warpgroup
      bar_sync(kSelBar, 128);   // every warp is done with the old window
      if (tid == 0) *sorted = 7;
      load_window_async(pts + static_cast<size_t>(w.b) * 3 * n, n,
                        lo_tile[tile] * kKeyTile, kx, ky, kz, tid);
      bar_sync(kSelBar, 128);
      // Which coordinates ascend over the whole window (bit a: axis a)?
      int up = 7;
      for (int j = tid; j < kWindow - 1; j += 128) {
        if (!(kx[j] <= kx[j + 1])) up &= ~1;
        if (!(ky[j] <= ky[j + 1])) up &= ~2;
        if (!(kz[j] <= kz[j + 1])) up &= ~4;
      }
      up = __reduce_and_sync(S4G_FULL_MASK, up);
      if (lane == 0) atomicAnd(sorted, up);
      bar_sync(kSelBar, 128);
      axis = __ffs(*sorted) - 1;   // -1: none, scan the whole window
      ka = axis == 0 ? kx : axis == 1 ? ky : kz;
      loaded = tile;
    }
    const int s = gi % stages;
    if (gi >= stages) bar_sync(kEmptyBar + s, kThreads);
    __nv_bfloat16* rel = reinterpret_cast<__nv_bfloat16*>(smem + kRingOff) +
                         s * kGroup * kpad * 3;
    int* cnt = reinterpret_cast<int*>(smem + kCntOff) + s * kGroup;
    const float* C = cents + static_cast<size_t>(w.b) * 3 * m;
    for (int cl = warp; cl < kGroup; cl += 4) {
      __nv_bfloat16* rc = rel + cl * kpad * 3;
      if (cl >= w.nc) {   // past M: zero rows, never written out
        for (int i = lane; i < kpad * 3; i += 32)
          rc[i] = __float2bfloat16_rn(0.f);
        if (lane == 0) cnt[cl] = 0;
        continue;
      }
      const int c = w.c0 + cl;
      const float cx = C[c], cy = C[m + c], cz = C[2 * m + c];
      // Along an ascending coordinate only the keys within the ball's slab
      // can be in range: scan the words that hold them (every other word
      // is all misses, so the ranks are the full scan's).
      int w_lo = 0, nw = kWords;
      if (axis >= 0) {
        const float ca = axis == 0 ? cx : axis == 1 ? cy : cz;
        const float mg = s4g_slab::margin(r2, ca);
        const int lo = s4g_slab::bound(ka, kWindow, ca - mg, false, lane);
        const int hi = s4g_slab::bound(ka, kWindow, ca + mg, true, lane);
        w_lo = lo / 32;
        nw = (hi + 31) / 32 - w_lo;
      }
      const int total = s4g_slab::scan_words(kx, ky, kz, cx, cy, cz, r2,
                                             words, prefix, w_lo, nw, lane);
      const int count = min(total, k);
      int first = 0;
      // Slots count..kpad-1 (duplicate fill, and the padding to kpad)
      // repeat slot 0: a repeat never changes the max.
      for (int s0 = 0; s0 < kpad; s0 += 32) {
        const int slot = s0 + lane;
        int j = 0;
        if (slot < count) {
          const int target = s4g_slab::slot_target(slot, total, k, stratified);
          j = w_lo * 32 + s4g_slab::rank_to_local(words, prefix, target, nw);
        }
        if (s0 == 0) first = __shfl_sync(S4G_FULL_MASK, j, 0);
        if (slot < kpad) {
          if (slot >= count) j = first;
          rc[slot * 3 + 0] = __float2bfloat16_rn(__fsub_rn(kx[j], cx));
          rc[slot * 3 + 1] = __float2bfloat16_rn(__fsub_rn(ky[j], cy));
          rc[slot * 3 + 2] = __float2bfloat16_rn(__fsub_rn(kz[j], cz));
        }
      }
      if (lane == 0) cnt[cl] = count;
      __syncwarp();
    }
    __syncwarp();
    bar_arrive(kFullBar + s, kThreads);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Layer 2, columns 64h..64h+63, as one committed group of 8 products.
__device__ __forceinline__ void l2_issue(float (&d)[32],
                                         const unsigned (&a1)[kKSteps][4],
                                         const unsigned char* w2s, int h) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
    wgmma_n64(d, a1[ks],
              b_desc(w2s + (ks / 4) * (kC2 * kRowBytes) + h * kN * kRowBytes +
                     (ks % 4) * 32));
  wgmma_commit();
}

__device__ __forceinline__ void l2_epilogue(const float (&d)[32],
                                            const float* b2s, int t, int h,
                                            unsigned (&a2)[kKSteps][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = h * kN + j * 8 + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(b2s + col);
    const int kk = 4 * h + j / 2, p = j % 2;
    a2[kk][2 * p] = pack_bf16(fmaxf(d[4 * j] + bb.x, 0.f),
                              fmaxf(d[4 * j + 1] + bb.y, 0.f));
    a2[kk][2 * p + 1] = pack_bf16(fmaxf(d[4 * j + 2] + bb.x, 0.f),
                                  fmaxf(d[4 * j + 3] + bb.y, 0.f));
  }
}

// Layer 3, columns 64ch..64ch+63, as one committed group of 8 products.
__device__ __forceinline__ void l3_issue(float (&d)[32],
                                         const unsigned (&a2)[kKSteps][4],
                                         const unsigned char* w3s, int c3,
                                         int ch) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
    wgmma_n64(d, a2[ks],
              b_desc(w3s + (ks / 4) * (c3 * kRowBytes) + ch * kN * kRowBytes +
                     (ks % 4) * 32));
  wgmma_commit();
}

// Max over this warp's 16 rows, + b3, ReLU, then into the pool slot.
// Adding b3 and the ReLU are monotone (rounding included), so they commute
// with the max and are applied to the two maxima a lane keeps, not to all
// 32 accumulators.  The results are >= 0, so their bits order as ints.
__device__ __forceinline__ void l3_pool(const float (&d)[32],
                                        const float* b3s, int g, int t,
                                        int ch, float* pl) {
  float v[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[2 * j] = fmaxf(d[4 * j], d[4 * j + 2]);
    v[2 * j + 1] = fmaxf(d[4 * j + 1], d[4 * j + 3]);
  }
  float m[2];
  rowmax_scatter(v, g, m);
  const int col = ch * kN + g * 8 + 2 * t;
  const float2 bb = *reinterpret_cast<const float2*>(b3s + col);
  int* pc = reinterpret_cast<int*>(pl + col);
  atomicMax(pc, __float_as_int(fmaxf(m[0] + bb.x, 0.f)));
  atomicMax(pc + 1, __float_as_int(fmaxf(m[1] + bb.y, 0.f)));
}

// Layer 1 of group row `row` (fragment row g) and row + 8 into the A
// fragments of all k-steps (k-step ks = columns 16ks..16ks+15).
__device__ __forceinline__ void layer1_rows(const __nv_bfloat16* rel,
                                            int row, const float* w1s,
                                            const float* b1s, int t,
                                            unsigned (&a1)[kKSteps][4]) {
  const __nv_bfloat16* ra = rel + row * 3;
  const __nv_bfloat16* rb = ra + 8 * 3;
  const float fa[3] = {__bfloat162float(ra[0]), __bfloat162float(ra[1]),
                       __bfloat162float(ra[2])};
  const float fb[3] = {__bfloat162float(rb[0]), __bfloat162float(rb[1]),
                       __bfloat162float(rb[2])};
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int col = ks * 16 + 2 * t;
    layer1_pair(fa, fb, w1s, b1s, col, a1[ks][0], a1[ks][1]);
    layer1_pair(fa, fb, w1s, b1s, col + 8, a1[ks][2], a1[ks][3]);
  }
}

// Warpgroups 0 and 1: the chain and the pool.  Warpgroup wg takes the
// group's 64-row tiles [wg * T/2, (wg+1) * T/2), T = kpad / 4 (at kpad 128
// a centroid's two tiles fall in one half).
__device__ __forceinline__ void chain_groups(
    unsigned char* smem, int m, int kpad, int c3, int stages, int gps,
    int g_lo, int ngroups, float* __restrict__ out) {
  const int wg = threadIdx.x / 128;
  const int ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, column pair
  const float* w1s = reinterpret_cast<const float*>(smem + kParOff);
  const float* b1s = w1s + 3 * kC1;
  const float* b2s = b1s + kC1;
  const float* b3s = b2s + kC2;
  float* pool = reinterpret_cast<float*>(smem + kPoolOff) +
                wg * kPoolSlots * kMaxC3;
  const unsigned char* w2s = smem + kW2Off;
  const unsigned char* w3s = smem + kW3Off;
  const int half = kpad / 8;                  // tiles per warpgroup
  const int per_tile = kpad < 64 ? 64 / kpad : 1;
  for (int gi = 0; gi < ngroups; ++gi) {
    const Work w = work_item(g_lo + gi, gps, m);
    const int s = gi % stages;
    bar_sync(kFullBar + s, kThreads);
    const __nv_bfloat16* rel =
        reinterpret_cast<const __nv_bfloat16*>(smem + kRingOff) +
        s * kGroup * kpad * 3;
    const int* cnt = reinterpret_cast<const int*>(smem + kCntOff) + s * kGroup;
    const int t_end = (wg + 1) * half;
    for (int tt = wg * half; tt < t_end; ++tt) {
      const int r0 = tt * 64;
      // Layer 1 straight into A fragments.  (Computing the next tile's
      // during layer 3 instead holds more registers than the 168 a thread
      // may use here, and the spills cost more than the overlap gains.)
      unsigned a1[kKSteps][4];
      layer1_rows(rel, r0 + 16 * warp + g, w1s, b1s, t, a1);

      // Layer 2: both 64-column halves issued at once; the first half's
      // epilogue (+ b2, ReLU, -> bf16 straight into layer 3's A fragments:
      // the accumulator layout of n-tiles 2kk and 2kk+1 is the A layout of
      // k-step kk) runs while the second half is on the tensor cores.
      unsigned a2[kKSteps][4];
      {
        float d0[32], d1[32];
        l2_issue(d0, a1, w2s, 0);
        l2_issue(d1, a1, w2s, 1);
        wgmma_wait<1>();
        fence_acc(d0);
        l2_epilogue(d0, b2s, t, 0, a2);
        wgmma_wait<0>();
        fence_acc(d1);
        l2_epilogue(d1, b2s, t, 1, a2);
      }

      // Layer 3 in 64-column chunks, two in flight (C3 is a multiple of
      // 128): max over the centroid's rows, + b3, ReLU into pool slot lc.
      // No branch between a chunk's issue and its wait, so ptxas can see
      // which group each wait retires and keeps the products pipelined.
      const int lc = (16 * warp + r0 % kpad) / kpad;
      float* pl = pool + lc * kMaxC3;
      for (int ch = 0; ch < c3 / kN; ch += 2) {
        float d0[32], d1[32];
        l3_issue(d0, a2, w3s, c3, ch);
        l3_issue(d1, a2, w3s, c3, ch + 1);
        wgmma_wait<1>();
        fence_acc(d0);
        l3_pool(d0, b3s, g, t, ch, pl);
        wgmma_wait<0>();
        fence_acc(d1);
        l3_pool(d1, b3s, g, t, ch + 1, pl);
      }

      // A tile that ends centroids writes them out and clears their slots.
      if ((r0 + 64) % kpad == 0) {
        bar_sync(kWgBar + wg, 128);
        const int first = (r0 + 64) / kpad - per_tile;
        for (int l = 0; l < per_tile; ++l) {
          const int cl = first + l;
          float* slot = pool + l * kMaxC3;
          if (cl < w.nc) {
            float* o = out + (static_cast<size_t>(w.b) * m + w.c0 + cl) * c3;
            const bool hit = cnt[cl] > 0;   // no key in range: a zero row
            for (int col = ct; col < c3; col += 128) {
              o[col] = hit ? slot[col] : 0.f;
              slot[col] = 0.f;
            }
          } else {
            for (int col = ct; col < c3; col += 128) slot[col] = 0.f;
          }
        }
        bar_sync(kWgBar + wg, 128);
      }
    }
    if (gi + stages < ngroups) bar_arrive(kEmptyBar + s, kThreads);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
sa1_fused_kernel(const float* __restrict__ pts,
                 const float* __restrict__ cents,
                 const int* __restrict__ lo_tile,
                 const uint4* __restrict__ wpack,
                 const float* __restrict__ fpack, int n, int m, int ntile,
                 float r2, int k, int kpad, int c3, int stratified,
                 int stages, int gps, int ngroups_all,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);

  // W2 and W3 as packed (bf16, swizzled): straight copies, cp.async.
  const int wunits = (kC1 * kC2 + kC2 * c3) * 2 / 16;
  for (int i = threadIdx.x; i < wunits; i += kThreads) {
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem + 16 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(wpack + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  float* par = reinterpret_cast<float*>(smem + kParOff);
  for (int i = threadIdx.x; i < 3 * kC1 + kC1 + kC2 + c3; i += kThreads)
    par[i] = fpack[i];
  float* pool = reinterpret_cast<float*>(smem + kPoolOff);
  for (int i = threadIdx.x; i < kPoolBytes / 4; i += kThreads) pool[i] = 0.f;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // The weights are read by wgmma (the async proxy).
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int g_lo = static_cast<int>(
      static_cast<long long>(blockIdx.x) * ngroups_all / gridDim.x);
  const int g_hi = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * ngroups_all / gridDim.x);
  if (threadIdx.x >= kConsumers * 128) {
    select_groups(smem, pts, cents, lo_tile, n, m, ntile, r2, k, kpad,
                  stratified, stages, gps, g_lo, g_hi - g_lo);
  } else {
    chain_groups(smem, m, kpad, c3, stages, gps, g_lo, g_hi - g_lo, out);
  }
}

}  // namespace

// wpack: W2 (C1 x C2) then W3 (C2 x C3), each in bf16 as sa_fused.py's
// pack_b_operand lays it out; fpack: f32 bf16-rounded W1 (3 x C1), b1, b2,
// b3.
extern "C" int s4g_sa1_fused(const float* pts, const float* cents,
                             const int* lo_tile, const void* wpack,
                             const float* fpack, int b, int n, int m,
                             int ntile, float r2, int k, int c3,
                             int stratified, float* out,
                             cudaStream_t stream) {
  if (b <= 0 || m <= 0 || k <= 0 || k > kMaxK || c3 <= 0 ||
      c3 % (2 * kN) != 0 || c3 > kMaxC3)
    return cudaErrorInvalidValue;
  int kpad = 16;
  while (kpad < k) kpad *= 2;
  // Two ring stages where they fit (kpad <= 64), else one; + 1 KB of
  // alignment slack.
  const size_t stage_bytes = static_cast<size_t>(kGroup) * kpad * 3 * 2;
  const int stages = kRingOff + 2 * stage_bytes + 1024 <= kS4gMaxSmem ? 2 : 1;
  const size_t smem = kRingOff + stages * stage_bytes + 1024;
  static size_t granted = 0;
  cudaError_t err = s4g_allow_smem(sa1_fused_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = s4g_sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int gps = (m + kGroup - 1) / kGroup;
  const int ngroups = b * gps;
  const int grid = ngroups < sms ? ngroups : sms;
  sa1_fused_kernel<<<grid, kThreads, smem, stream>>>(
      pts, cents, lo_tile, static_cast<const uint4*>(wpack), fpack, n, m,
      ntile, r2, k, kpad, c3, stratified, stages, gps, ngroups, out);
  return cudaGetLastError();
}
