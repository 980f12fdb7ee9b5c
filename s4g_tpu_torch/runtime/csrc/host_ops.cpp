// Host-side point-cloud kernels of the s4g_tpu_torch runtime (the port's
// own copy of s4g_tpu/runtime/csrc/host_ops.cpp; a host C++ library, no
// GPU code).
//
// The GPU owns the detect path; these native kernels serve the host-side
// data plumbing where the reference leaned on Open3D's C++
// (voxel_down_sample_and_trace / remove_radius_outlier,
// reference cloud_processor.py:31-43,
// torch_precomputed_single_view_point_cloud.py:87-95): a hash-grid voxel
// downsample with max-index trace, a grid-accelerated radius outlier
// filter and a grid 1-NN match.  Exposed through a plain C ABI for ctypes.
//
// Design: a flat open-addressing hash (exact int32 cell coords,
// splitmix64, linear probing) feeding a counting-sorted point index, and
// the 27-cell neighborhood scanned CENTER-FIRST so dense clouds early-exit
// after a handful of distance checks (per-cell heap vectors and
// node-based buckets made the outlier filter ~17x slower).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC host_ops.cpp -o libs4g_host.so

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

inline uint64_t mix64(uint64_t v) {  // splitmix64 finalizer
    v += 0x9e3779b97f4a7c15ull;
    v = (v ^ (v >> 30)) * 0xbf58476d1ce4e5b9ull;
    v = (v ^ (v >> 27)) * 0x94d049bb133111ebull;
    return v ^ (v >> 31);
}

// Saturating float -> int32 cell index: the raw cast is UB once
// |v * inv| exceeds int32 (invalid-depth sentinel points at 1e8 m), and
// NaN casts to an unspecified value.  Saturation merges absurd far-field
// garbage into the extreme cells without corrupting anything.
inline int32_t cell_of(float v, float inv) {
    const float c = std::floor(v * inv);
    if (!(c >= -2147483648.0f)) return INT32_MIN;  // also catches NaN
    if (c >= 2147483647.0f) return INT32_MAX;
    return static_cast<int32_t>(c);
}

struct Cell {
    int32_t x, y, z;
};

// Open-addressing cell table: exact (x, y, z) cell coords -> dense slot id
// (insertion order).  Coordinates are stored and compared EXACTLY — a
// packed-bits key would alias distinct far-apart cells (the predecessor
// unordered_map was exact for any int32 cell, and so is this).
struct CellTable {
    std::vector<Cell> cells;
    std::vector<int32_t> slots;  // -1 = empty bucket
    uint64_t mask = 0;
    int32_t n_slots = 0;

    explicit CellTable(int64_t expected) {
        uint64_t cap = 64;
        while (cap < static_cast<uint64_t>(expected) * 2) cap <<= 1;
        cells.resize(cap);
        slots.assign(cap, -1);
        mask = cap - 1;
    }

    static uint64_t hash(int32_t x, int32_t y, int32_t z) {
        uint64_t h = mix64(static_cast<uint32_t>(x));
        h = mix64(h ^ static_cast<uint32_t>(y));
        return mix64(h ^ static_cast<uint32_t>(z));
    }

    int32_t find_or_insert(int32_t x, int32_t y, int32_t z) {
        uint64_t h = hash(x, y, z) & mask;
        while (true) {
            const int32_t s = slots[h];
            if (s < 0) {
                cells[h] = Cell{x, y, z};
                slots[h] = n_slots;
                return n_slots++;
            }
            const Cell& c = cells[h];
            if (c.x == x && c.y == y && c.z == z) return s;
            h = (h + 1) & mask;
        }
    }

    int32_t find(int32_t x, int32_t y, int32_t z) const {
        uint64_t h = hash(x, y, z) & mask;
        while (true) {
            const int32_t s = slots[h];
            if (s < 0) return -1;
            const Cell& c = cells[h];
            if (c.x == x && c.y == y && c.z == z) return s;
            h = (h + 1) & mask;
        }
    }
};

// Counting-sorted point-in-cell index: points of cell s occupy
// point_ids[starts[s] .. starts[s+1]).
struct CellIndex {
    CellTable table;
    std::vector<int32_t> cell_of_point;
    std::vector<int32_t> starts;     // (n_slots + 1)
    std::vector<int32_t> point_ids;  // (n), counting-sorted by cell
    std::vector<float> coords;       // (n * 3), same order as point_ids —
                                     // dense per-cell blocks vectorize the
                                     // distance scans

    CellIndex(const float* points, int64_t n, float inv)
        : table(n), cell_of_point(n), point_ids(n), coords(n * 3) {
        for (int64_t i = 0; i < n; ++i) {
            const float* p = points + i * 3;
            cell_of_point[i] = table.find_or_insert(
                cell_of(p[0], inv), cell_of(p[1], inv), cell_of(p[2], inv));
        }
        starts.assign(table.n_slots + 1, 0);
        for (int64_t i = 0; i < n; ++i) ++starts[cell_of_point[i] + 1];
        for (int32_t s = 0; s < table.n_slots; ++s) starts[s + 1] += starts[s];
        std::vector<int32_t> cursor(starts.begin(), starts.end() - 1);
        for (int64_t i = 0; i < n; ++i) {
            const int32_t c = cursor[cell_of_point[i]]++;
            point_ids[c] = static_cast<int32_t>(i);
            coords[c * 3 + 0] = points[i * 3 + 0];
            coords[c * 3 + 1] = points[i * 3 + 1];
            coords[c * 3 + 2] = points[i * 3 + 2];
        }
    }
};

// 27 neighborhood offsets ordered CENTER-FIRST (by L1 distance): dense
// clouds satisfy min_neighbors inside the home cell and early-exit there.
struct NeighborOrder {
    int32_t d[27][3];
    NeighborOrder() {
        int k = 0;
        for (int ring = 0; ring <= 3; ++ring)
            for (int dx = -1; dx <= 1; ++dx)
                for (int dy = -1; dy <= 1; ++dy)
                    for (int dz = -1; dz <= 1; ++dz)
                        if (std::abs(dx) + std::abs(dy) + std::abs(dz) ==
                            ring) {
                            d[k][0] = dx; d[k][1] = dy; d[k][2] = dz;
                            ++k;
                        }
    }
};
const NeighborOrder kOrder;

}  // namespace

extern "C" {

// Voxel downsample with per-voxel mean position and max-original-index trace.
// points: (n, 3) float32. out_points: (capacity, 3). out_trace: (capacity,).
// Returns the number of voxels written (<= capacity).  Output order is
// voxel-discovery (first-point-in-voxel) order.
int64_t voxel_downsample_trace(const float* points, int64_t n,
                               float voxel_size, float origin_x,
                               float origin_y, float origin_z,
                               float* out_points, int64_t* out_trace,
                               int64_t capacity) {
    CellTable table(n);
    std::vector<double> sums;
    std::vector<int32_t> counts;
    std::vector<int64_t> max_index;
    sums.reserve(n * 3);
    const float inv = 1.0f / voxel_size;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = points + i * 3;
        const int32_t s = table.find_or_insert(
            cell_of(p[0] - origin_x, inv), cell_of(p[1] - origin_y, inv),
            cell_of(p[2] - origin_z, inv));
        if (s == static_cast<int32_t>(counts.size())) {
            sums.insert(sums.end(), {0.0, 0.0, 0.0});
            counts.push_back(0);
            max_index.push_back(-1);
        }
        sums[s * 3 + 0] += p[0];
        sums[s * 3 + 1] += p[1];
        sums[s * 3 + 2] += p[2];
        counts[s] += 1;
        if (i > max_index[s]) max_index[s] = i;
    }
    const int64_t out = counts.size() < static_cast<size_t>(capacity)
                            ? static_cast<int64_t>(counts.size())
                            : capacity;
    for (int64_t s = 0; s < out; ++s) {
        out_points[s * 3 + 0] = static_cast<float>(sums[s * 3 + 0] / counts[s]);
        out_points[s * 3 + 1] = static_cast<float>(sums[s * 3 + 1] / counts[s]);
        out_points[s * 3 + 2] = static_cast<float>(sums[s * 3 + 2] / counts[s]);
        out_trace[s] = max_index[s];
    }
    return out;
}

// Radius outlier filter: keep[i] = 1 when >= min_neighbors points (self
// included) lie within radius.  Grid-accelerated: O(n * k) instead of O(n^2).
void radius_outlier_mask(const float* points, int64_t n, float radius,
                         int32_t min_neighbors, uint8_t* keep) {
    const float inv = 1.0f / radius;
    const float r2 = radius * radius;
    CellIndex index(points, n, inv);
    for (int64_t i = 0; i < n; ++i) {
        const float* p = points + i * 3;
        const int32_t cx = cell_of(p[0], inv);
        const int32_t cy = cell_of(p[1], inv);
        const int32_t cz = cell_of(p[2], inv);
        int32_t count = 0;
        // Home cell first via the slot remembered from the build (no hash
        // lookup); k = 0 in kOrder IS the home cell, so start k at 1.
        for (int k = 0; k < 27 && count < min_neighbors; ++k) {
            const int32_t s =
                k == 0 ? index.cell_of_point[i]
                       : index.table.find(cx + kOrder.d[k][0],
                                          cy + kOrder.d[k][1],
                                          cz + kOrder.d[k][2]);
            if (s < 0) continue;
            const int32_t e = index.starts[s + 1];
            for (int32_t c = index.starts[s]; c < e; ++c) {
                const float* q = &index.coords[c * 3];
                const float ddx = p[0] - q[0];
                const float ddy = p[1] - q[1];
                const float ddz = p[2] - q[2];
                if (ddx * ddx + ddy * ddy + ddz * ddz < r2) {
                    if (++count >= min_neighbors) break;
                }
            }
        }
        keep[i] = count >= min_neighbors ? 1 : 0;
    }
}

// 1-NN match of query points into a reference cloud within max_radius.
// Grid-accelerated; out_index[i] = -1 when nothing within max_radius.
void nearest_neighbor_match(const float* query, int64_t nq,
                            const float* ref, int64_t nr, float max_radius,
                            int64_t* out_index, float* out_dist2) {
    const float inv = 1.0f / max_radius;
    const float r2 = max_radius * max_radius;
    CellIndex index(ref, nr, inv);
    for (int64_t i = 0; i < nq; ++i) {
        const float* p = query + i * 3;
        const int32_t cx = cell_of(p[0], inv);
        const int32_t cy = cell_of(p[1], inv);
        const int32_t cz = cell_of(p[2], inv);
        int64_t best = -1;
        float best_d = r2;
        for (int k = 0; k < 27; ++k) {
            const int32_t s = index.table.find(
                cx + kOrder.d[k][0], cy + kOrder.d[k][1],
                cz + kOrder.d[k][2]);
            if (s < 0) continue;
            const int32_t e = index.starts[s + 1];
            for (int32_t c = index.starts[s]; c < e; ++c) {
                const int32_t j = index.point_ids[c];
                const float* q = &index.coords[c * 3];
                const float ddx = p[0] - q[0];
                const float ddy = p[1] - q[1];
                const float ddz = p[2] - q[2];
                const float d = ddx * ddx + ddy * ddy + ddz * ddz;
                if (d <= best_d) {
                    // ties resolve to the lower index like the KD-tree in
                    // the reference
                    if (d < best_d || best < 0 || j < best) {
                        best_d = d;
                        best = j;
                    }
                }
            }
        }
        out_index[i] = best;
        out_dist2[i] = best >= 0 ? best_d : -1.0f;
    }
}

}  // extern "C"
