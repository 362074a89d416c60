// Native vertex deduplication for STL surface meshes.
//
// The reference deduplicates shared triangle vertices with an O(ntri^2)
// linear scan at 1e-13 per-coordinate tolerance (subs.f90:69-93).  This is
// the same semantics in O(n): a spatial hash over tolerance-sized cells;
// each incoming point probes its own and neighboring cells for an existing
// match (Chebyshev/per-coordinate tolerance, like the reference's abs-diff
// comparisons) and otherwise becomes a new unique vertex.  First-occurrence
// order is preserved, so node numbering matches the reference scheme.
//
// Built on demand by levelsetfortran_jax.native (g++ -O3 -shared -fPIC) and
// called through ctypes; the NumPy exact-match path remains the fallback.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

inline int64_t quantize(double v, double inv_cell) {
    return static_cast<int64_t>(std::floor(v * inv_cell));
}

inline uint64_t cell_key(int64_t ix, int64_t iy, int64_t iz) {
    // large-prime mix of the three cell coordinates
    uint64_t h = static_cast<uint64_t>(ix) * 0x9E3779B185EBCA87ULL;
    h ^= static_cast<uint64_t>(iy) * 0xC2B2AE3D27D4EB4FULL;
    h ^= static_cast<uint64_t>(iz) * 0x165667B19E3779F9ULL;
    return h;
}

}  // namespace

extern "C" {

// pts: n*3 float32 (triangle-soup vertices, input order)
// tol: per-coordinate match tolerance (reference: 1e-13)
// out_verts: capacity n*3 float64 — unique vertices, first-occurrence order
// inverse:   n int32 — unique index of each input point
// returns the number of unique vertices (or -1 on bad input)
long long stl_dedup_vertices(const float* pts, long long n, double tol,
                             double* out_verts, int32_t* inverse) {
    if (n < 0 || !pts || !out_verts || !inverse) return -1;
    const double cell = tol > 0.0 ? tol : 1e-300;
    const double inv_cell = 1.0 / cell;

    std::unordered_map<uint64_t, std::vector<int32_t>> buckets;
    buckets.reserve(static_cast<size_t>(n) * 2 + 16);
    long long n_unique = 0;

    for (long long i = 0; i < n; ++i) {
        const double x = static_cast<double>(pts[3 * i + 0]);
        const double y = static_cast<double>(pts[3 * i + 1]);
        const double z = static_cast<double>(pts[3 * i + 2]);
        const int64_t cx = quantize(x, inv_cell);
        const int64_t cy = quantize(y, inv_cell);
        const int64_t cz = quantize(z, inv_cell);

        int32_t found = -1;
        for (int dx = -1; dx <= 1 && found < 0; ++dx)
            for (int dy = -1; dy <= 1 && found < 0; ++dy)
                for (int dz = -1; dz <= 1 && found < 0; ++dz) {
                    auto it = buckets.find(cell_key(cx + dx, cy + dy,
                                                    cz + dz));
                    if (it == buckets.end()) continue;
                    for (int32_t j : it->second) {
                        if (std::fabs(out_verts[3 * j + 0] - x) <= tol &&
                            std::fabs(out_verts[3 * j + 1] - y) <= tol &&
                            std::fabs(out_verts[3 * j + 2] - z) <= tol) {
                            found = j;
                            break;
                        }
                    }
                }

        if (found >= 0) {
            inverse[i] = found;
        } else {
            const int32_t id = static_cast<int32_t>(n_unique++);
            out_verts[3 * id + 0] = x;
            out_verts[3 * id + 1] = y;
            out_verts[3 * id + 2] = z;
            buckets[cell_key(cx, cy, cz)].push_back(id);
            inverse[i] = id;
        }
    }
    return n_unique;
}

}  // extern "C"
