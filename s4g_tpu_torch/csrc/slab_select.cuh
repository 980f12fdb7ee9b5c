// Neighbour selection shared by K2 (ball_query_slab.cu), K3 (sa1_fused.cu)
// and K2f (ball_query_full.cu), so that all three select the same keys bit
// for bit, and the slab bounds the three scan on keys that ascend.
//
// A key is in range when its f32 difference-form squared distance is < r2
// (strict); each 32-key chunk becomes one ballot word.  Slot s takes the
// in-range key of scan rank s+1, or, with `stratified` and an overfull ball
// (total > K), of rank floor(s*total/K)+1.  The slab kernels scan the
// 8,192-key window that starts at key lo_tile * 2048 (keys past N are
// padding, 1e9, never in range); K2f scans all N keys.  Where the keys
// ascend along a coordinate, the three scan only the words that hold keys
// within `margin` of the centroid along it (`bound`): every other key is
// out of range, so ranks, totals and slots are the full scan's.
#pragma once

#include "common.cuh"

namespace s4g_slab {

constexpr int kCentroidTile = 512;    // BQ_C_TILE / SA_C_TILE
constexpr int kKeyTile = 2048;        // BQ_K_TILE / SA_K_TILE
constexpr int kWindow = 4 * kKeyTile; // (BQ|SA)_SLAB_TILES * key tile keys
constexpr int kWords = kWindow / 32;  // one ballot word per 32 keys
static_assert(kWords == 32 * 8, "the word scan gives each lane 8 words");

// One warp: inclusive prefix counts of `nwords` ballot words (each lane
// counts a run of consecutive words, then a warp scan).  Returns the total.
__device__ __forceinline__ int prefix_counts(const unsigned* words,
                                             int* prefix, int nwords,
                                             int lane) {
  const int per = (nwords + 31) / 32;
  const int lo = min(lane * per, nwords);
  const int hi = min(lo + per, nwords);
  int run = 0;
  for (int w = lo; w < hi; ++w) run += __popc(words[w]);
  int incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(S4G_FULL_MASK, incl, o);
    if (lane >= o) incl += t;
  }
  int acc = incl - run;
  for (int w = lo; w < hi; ++w) {
    acc += __popc(words[w]);
    prefix[w] = acc;
  }
  const int total = __shfl_sync(S4G_FULL_MASK, incl, 31);
  __syncwarp();
  return total;
}

// One warp: the in-range ballot words of centroid (cx, cy, cz) over the
// keys' words [w_lo, w_lo + nw), into words[0 .. nw).
__device__ __forceinline__ void ballot_words(const float* kx, const float* ky,
                                             const float* kz, float cx,
                                             float cy, float cz, float r2,
                                             unsigned* words, int w_lo, int nw,
                                             int lane) {
  // One in-range ballot word per 32-key chunk.  Lane i keeps word w0 + i of
  // each run of 32 in a register and stores it after the run, so the loop
  // body holds no store and the key loads of several words are in flight.
  for (int w0 = 0; w0 < nw; w0 += 32) {
    const int len = min(32, nw - w0);
    unsigned mine = 0;
#pragma unroll 8
    for (int i = 0; i < len; ++i) {
      const int j = (w_lo + w0 + i) * 32 + lane;
      const float d = s4g_sqdist(kx[j], ky[j], kz[j], cx, cy, cz);
      const unsigned bits = __ballot_sync(S4G_FULL_MASK, d < r2);
      mine = lane == i ? bits : mine;
    }
    if (lane < len) words[w0 + lane] = mine;
  }
}

// The same, then the words' inclusive prefix counts.  Returns the number of
// in-range keys among them.
__device__ __forceinline__ int scan_words(const float* kx, const float* ky,
                                          const float* kz, float cx, float cy,
                                          float cz, float r2, unsigned* words,
                                          int* prefix, int w_lo, int nw,
                                          int lane) {
  ballot_words(kx, ky, kz, cx, cy, cz, r2, words, w_lo, nw, lane);
  __syncwarp();
  return prefix_counts(words, prefix, nw, lane);
}

// Half-width of a ball's slab along an ascending coordinate: a key farther
// than this from the centroid (after f32 rounding of the bound) has
// |dx| > 1.04 sqrt(r2), so its squared distance rounds to more than r2.
__device__ __forceinline__ float margin(float r2, float c) {
  return 1.05f * sqrtf(r2) + 1e-5f * fabsf(c);
}

// One warp: the first index of ka[0, n) whose key is >= v (> v with
// `after`).  The keys ascend, so "before" holds for a prefix.  Each round
// probes 32 evenly spaced keys with one ballot and keeps the bucket where
// "before" ends (8,192 keys: buckets of 256, 8, 1), not log2(n) dependent
// loads.  A NaN bound is before no key.
__device__ __forceinline__ int bound(const float* __restrict__ ka, int n,
                                    float v, bool after, int lane) {
  auto before = [&](float x) { return after ? x <= v : x < v; };
  int lo = 0, len = n;  // the answer lies in [lo, lo + len]
  while (len > 0) {
    const int step = (len + 31) / 32;
    const int probe = lo + (lane + 1) * step - 1;
    const bool t = probe < lo + len && before(ka[probe]);
    const int hi = lo + len;
    lo += step * __popc(__ballot_sync(S4G_FULL_MASK, t));
    len = min(hi, lo + step - 1) - lo;
  }
  return lo;
}

// The scan rank (1-based) that slot `slot` takes.
__device__ __forceinline__ int slot_target(int slot, int total, int k,
                                           int stratified) {
  return (stratified && total > k) ? (slot * total) / k + 1 : slot + 1;
}

// Index, among the `nwords` words' keys, of the in-range key of scan rank
// `target` (1 <= target <= total): binary search for the first word whose
// prefix reaches the target, then a bit walk inside that word.
__device__ __forceinline__ int rank_to_local(const unsigned* words,
                                             const int* prefix, int target,
                                             int nwords = kWords) {
  int lo = 0, hi = nwords - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (prefix[mid] >= target) hi = mid; else lo = mid + 1;
  }
  int rank = target - (lo > 0 ? prefix[lo - 1] : 0);
  unsigned word = words[lo];
  while (--rank > 0) word &= word - 1;  // drop the lower set bits
  return lo * 32 + (__ffs(word) - 1);
}

}  // namespace s4g_slab
