// Native greedy mesher + host-side frame-loop helpers.
//
// The binary greedy merge is the one genuinely sequential, scalar-heavy
// algorithm in the engine (reference: src/meshing/binary_greedy.rs:683-807).
// It runs on the host feeding the device-resident quad pool, so it is
// implemented in C++ with the same bit-twiddling structure the Rust
// reference uses (trailing_zeros / trailing_ones scans with bit
// consumption).  Exposed via a tiny C ABI consumed through ctypes.
//
// Also hosts the sequential culling passes that are order-dependent and
// therefore host-side: horizon culling (src/rendering/culling.rs:40-119)
// and the chunk occlusion pre-pass (src/rendering/occlusion.rs:60-154).

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// Greedy-merge per-type slice masks into packed 32-bit quads.
//
// masks: uint32[6][4][32][32]  (face, block_type, slice, row; bit = col)
// out:   packed quads, capacity `cap`
// Returns number of quads emitted (may exceed cap; only cap are written).
//
// Packing must match meshing/quad_format.py.
static int64_t greedy_merge_all(const uint32_t* masks, uint32_t* out,
                                int64_t cap) {
    int64_t n = 0;
    for (int face = 0; face < 6; ++face) {
        for (int slice = 0; slice < 32; ++slice) {
            for (int btype = 0; btype < 4; ++btype) {
                const uint32_t* src = masks + (((face * 4 + btype) * 32 + slice) * 32);
                uint32_t data[32];
                // quick emptiness check
                uint32_t any = 0;
                for (int r = 0; r < 32; ++r) { data[r] = src[r]; any |= src[r]; }
                if (!any) continue;
                for (int row = 0; row < 32; ++row) {
                    if (data[row] == 0) continue;
                    uint32_t col = 0;
                    while (col < 32) {
                        uint32_t rest = data[row] >> col;
                        if (rest == 0) break;
                        col += (uint32_t)__builtin_ctz(rest);
                        rest = data[row] >> col;
                        // trailing ones
                        uint32_t inv = ~rest;
                        uint32_t height = inv ? (uint32_t)__builtin_ctz(inv) : 32u;
                        uint32_t height_mask =
                            height >= 32 ? 0xFFFFFFFFu : ((1u << height) - 1u);
                        uint32_t mask = height_mask << col;
                        uint32_t width = 1;
                        while (row + (int)width < 32) {
                            if (((data[row + width] >> col) & height_mask) != height_mask)
                                break;
                            data[row + width] &= ~mask;
                            ++width;
                        }
                        if (n < cap) {
                            uint32_t q = (uint32_t)(row & 0x1F)
                                | (((uint32_t)col & 0x1F) << 5)
                                | (((width - 1u) & 0x3F) << 10)
                                | (((height - 1u) & 0x3F) << 16)
                                | (((uint32_t)btype & 0x3u) << 22)
                                | (((uint32_t)slice & 0x1Fu) << 24)
                                | (((uint32_t)face & 0x7u) << 29);
                            out[n] = q;
                        }
                        ++n;
                        data[row] &= ~mask;
                        col += height;
                    }
                }
            }
        }
    }
    return n;
}

int64_t greedy_mesh_masks(const uint32_t* masks, uint32_t* out, int64_t cap) {
    return greedy_merge_all(masks, out, cap);
}

// Full-chunk meshing in one native call: dense blocks + neighbor boundary
// planes -> packed quads.  Fuses the mask construction (the numpy
// pack_slice_masks path costs ~0.6 ms/chunk in Python-call overhead) with
// the greedy merge.  Bit-identical to
// mesh_from_masks(pack_slice_masks(exposed_faces(...))) — tested in
// tests/test_meshing.py.
//
// blocks:    uint8[32][32][32], indexed [z][y][x] (chunk.rs:52 layout)
// nb_planes: uint8[6][32][32] neighbor solidity planes, the layout of
//            face_masks.neighbor_solid_planes (X faces [z][y],
//            Y faces [z][x], Z faces [y][x])
// out/cap:   packed quad output; returns the total emitted count (may
//            exceed cap; only cap quads are written).
int64_t mesh_chunk_full(const uint8_t* blocks, const uint8_t* nb_planes,
                        uint32_t* out, int64_t cap) {
    // solidity as bitmasks over x per (z, y); solid iff code != 0
    // (models/chunk.py solid(): BLOCK_IS_SOLID[min(code, 3)])
    uint32_t solid[32][32];
    for (int z = 0; z < 32; ++z) {
        for (int y = 0; y < 32; ++y) {
            const uint8_t* rowp = blocks + ((z * 32 + y) * 32);
            uint32_t m = 0;
            for (int x = 0; x < 32; ++x)
                m |= (uint32_t)(rowp[x] != 0) << x;
            solid[z][y] = m;
        }
    }
    // neighbor planes as x-bitmasks where the plane's minor axis is x
    const uint8_t* pl = nb_planes;
    uint32_t py[2][32], pz[2][32];  // +Y/-Y over [z], +Z/-Z over [y]
    for (int f = 0; f < 2; ++f) {
        const uint8_t* p2 = pl + (2 + f) * 32 * 32;  // [z][x]
        const uint8_t* p4 = pl + (4 + f) * 32 * 32;  // [y][x]
        for (int a = 0; a < 32; ++a) {
            uint32_t m2 = 0, m4 = 0;
            for (int x = 0; x < 32; ++x) {
                m2 |= (uint32_t)(p2[a * 32 + x] != 0) << x;
                m4 |= (uint32_t)(p4[a * 32 + x] != 0) << x;
            }
            py[f][a] = m2;
            pz[f][a] = m4;
        }
    }

    // per-(face, btype) slice masks, same layout as greedy_mesh_masks input
    static thread_local uint32_t masks[6 * 4 * 32 * 32];
    std::memset(masks, 0, sizeof(uint32_t) * 6 * 4 * 32 * 32);

    for (int z = 0; z < 32; ++z) {
        for (int y = 0; y < 32; ++y) {
            const uint32_t s = solid[z][y];
            if (!s) continue;
            const uint8_t* rowp = blocks + ((z * 32 + y) * 32);
            uint32_t ex[6];
            // +X: neighbor occupancy at x+1 (border bit 31 from plane [z][y])
            ex[0] = s & ~((s >> 1) |
                          ((uint32_t)(pl[(0 * 32 + z) * 32 + y] != 0) << 31));
            // -X: neighbor at x-1 (border bit 0)
            ex[1] = s & ~((s << 1) |
                          (uint32_t)(pl[(1 * 32 + z) * 32 + y] != 0));
            ex[2] = s & ~(y < 31 ? solid[z][y + 1] : py[0][z]);
            ex[3] = s & ~(y > 0 ? solid[z][y - 1] : py[1][z]);
            ex[4] = s & ~(z < 31 ? solid[z + 1][y] : pz[0][y]);
            ex[5] = s & ~(z > 0 ? solid[z - 1][y] : pz[1][y]);
            for (int f = 0; f < 6; ++f) {
                uint32_t m = ex[f];
                while (m) {
                    const int x = __builtin_ctz(m);
                    m &= m - 1;
                    const int bt = rowp[x];
                    if (bt < 1 || bt > 3) continue;  // only types 1..3 emit
                    uint32_t* mk = masks + ((f * 4 + bt) * 32) * 32;
                    if (f < 2)       mk[x * 32 + y] |= 1u << z;  // slice=x,row=y,col=z
                    else if (f < 4)  mk[y * 32 + x] |= 1u << z;  // slice=y,row=x,col=z
                    else             mk[z * 32 + x] |= 1u << y;  // slice=z,row=x,col=y
                }
            }
        }
    }
    return greedy_merge_all(masks, out, cap);
}

// Horizon culling (reference src/rendering/culling.rs:40-119).
//
// Inputs are pre-sorted front-to-back by the caller.
//   centers: f32[n][3] mesh centers (world space)
//   cam:     f32[3]
//   keep:    out uint8[n]
// Config mirrors HorizonCullingConfig (culling.rs:27-35).
void horizon_cull(const float* centers, int64_t n, const float* cam,
                  int32_t bins, float base_margin, float margin_dist_factor,
                  float min_dist_chunks, float chunk_size, uint8_t* keep) {
    const float PI = 3.14159265358979323846f;
    // bins <= 4096 guard
    float horizon[4096];
    if (bins > 4096) bins = 4096;
    for (int i = 0; i < bins; ++i) horizon[i] = -INFINITY;
    const float half_chunk = chunk_size * 0.5f;
    for (int64_t i = 0; i < n; ++i) {
        const float dx = centers[i * 3 + 0] - cam[0];
        const float dy = centers[i * 3 + 1] - cam[1];
        const float dz = centers[i * 3 + 2] - cam[2];
        const float dist_xz = std::sqrt(dx * dx + dz * dz);
        if (dist_xz < 1e-3f) { keep[i] = 1; continue; }
        const float dist_chunks = dist_xz / chunk_size;
        if (dist_chunks < min_dist_chunks) { keep[i] = 1; continue; }
        const float angle = std::atan2(dz, dx);
        float bin_f = (angle + PI) / (2.0f * PI) * (float)bins;
        int64_t bin = (int64_t)std::floor(bin_f);
        if (bin < 0) bin += bins;
        bin %= bins;
        const float slope = dy / dist_xz;
        const float margin = base_margin * (1.0f + dist_chunks * margin_dist_factor);
        const float current = horizon[bin];
        const bool cull = slope >= 0.0f && (slope + margin) < current;
        if (!cull) {
            keep[i] = 1;
            const float top_slope = (dy + half_chunk) / dist_xz;
            if (top_slope > current) horizon[bin] = top_slope;
        } else {
            keep[i] = 0;
        }
    }
}

// Chunk-level occlusion pre-pass (reference src/rendering/occlusion.rs +
// src/main.rs:500-526): sequential front-to-back over projected rects.
//   rects:   i32[n][4] (min_x, min_y, max_x, max_y) inclusive pixel rects
//   depths:  f32[n] near depth per rect
//   use_occ: uint8[n] per-rect "participates in occlusion query" flag
//            (main.rs:474-478: only beyond 2 chunks distance)
//   keep:    out uint8[n]
void occlusion_pass(const int32_t* rects, const float* depths,
                    const uint8_t* use_occ, int64_t n,
                    int32_t screen_w, int32_t screen_h,
                    int32_t grid_w, int32_t grid_h,
                    float epsilon, uint8_t* keep) {
    if (grid_w * grid_h > 65536 || screen_w <= 0 || screen_h <= 0) {
        for (int64_t i = 0; i < n; ++i) keep[i] = 1;
        return;
    }
    float cells[65536];
    for (int i = 0; i < grid_w * grid_h; ++i) cells[i] = INFINITY;

    for (int64_t i = 0; i < n; ++i) {
        int32_t min_x = rects[i * 4 + 0], min_y = rects[i * 4 + 1];
        int32_t max_x = rects[i * 4 + 2], max_y = rects[i * 4 + 3];
        const float near_depth = depths[i];
        // clamp (occlusion.rs:72-81)
        bool offscreen = (max_x < 0 || max_y < 0 || min_x >= screen_w || min_y >= screen_h);
        if (min_x < 0) min_x = 0;
        if (min_y < 0) min_y = 0;
        if (max_x > screen_w - 1) max_x = screen_w - 1;
        if (max_y > screen_h - 1) max_y = screen_h - 1;
        bool empty = offscreen || (min_x > max_x || min_y > max_y);

        bool occluded = false;
        if (!empty) {
            const int cx0 = (int)((int64_t)min_x * grid_w / screen_w);
            const int cx1 = (int)((int64_t)max_x * grid_w / screen_w);
            const int cy0 = (int)((int64_t)min_y * grid_h / screen_h);
            const int cy1 = (int)((int64_t)max_y * grid_h / screen_h);
            if (use_occ[i]) {
                occluded = true;
                for (int cy = cy0; cy <= cy1 && occluded; ++cy)
                    for (int cx = cx0; cx <= cx1; ++cx)
                        if (!(cells[cy * grid_w + cx] < near_depth - epsilon)) {
                            occluded = false;
                            break;
                        }
            }
            if (!occluded) {
                for (int cy = cy0; cy <= cy1; ++cy)
                    for (int cx = cx0; cx <= cx1; ++cx) {
                        float* cell = &cells[cy * grid_w + cx];
                        if (near_depth < *cell) *cell = near_depth;
                    }
            }
        }
        keep[i] = occluded ? 0 : 1;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Independent twin of models/perlin.py for cross-checking the seeded
// terrain RNG (the Rust reference's noise-0.9.0 Perlin; see chunk.rs:114-177
// and the perlin.py docstring).  Written separately from the numpy
// implementation so transcription bugs in either side fail the parity test
// (tests/test_perlin_fixtures.py); cargo/crate source are unavailable here.
// ---------------------------------------------------------------------------

namespace perlin_twin {

struct XorShift {
    uint32_t x, y, z, w;
    explicit XorShift(const uint8_t seed[16]) {
        uint32_t s[4];
        for (int i = 0; i < 4; i++) {
            s[i] = (uint32_t)seed[4 * i] | ((uint32_t)seed[4 * i + 1] << 8) |
                   ((uint32_t)seed[4 * i + 2] << 16) |
                   ((uint32_t)seed[4 * i + 3] << 24);
        }
        if (!(s[0] | s[1] | s[2] | s[3]))
            s[0] = s[1] = s[2] = s[3] = 0x0BAD5EEDu;
        x = s[0]; y = s[1]; z = s[2]; w = s[3];
    }
    uint32_t next() {
        uint32_t t = x ^ (x << 11);
        x = y; y = z; z = w;
        w = w ^ (w >> 19) ^ (t ^ (t >> 8));
        return w;
    }
    // rand 0.8 UniformInt<u32>::sample_single
    uint32_t gen_range(uint32_t upper) {
        int lz = __builtin_clz(upper);
        uint32_t zone = (upper << lz) - 1u;
        for (;;) {
            uint64_t m = (uint64_t)next() * upper;
            if ((uint32_t)m <= zone) return (uint32_t)(m >> 32);
        }
    }
};

static void table_from_seed(uint32_t seed, uint8_t out[256]) {
    uint8_t sb[16] = {0};
    sb[0] = 1;
    sb[1] = (uint8_t)seed;
    sb[2] = (uint8_t)(seed >> 8);
    sb[3] = (uint8_t)(seed >> 16);
    sb[4] = (uint8_t)(seed >> 24);
    XorShift rng(sb);
    for (int i = 0; i < 256; i++) out[i] = (uint8_t)i;
    for (int i = 255; i >= 1; i--) {
        uint32_t j = rng.gen_range((uint32_t)i + 1);
        uint8_t t = out[i]; out[i] = out[j]; out[j] = t;
    }
}

static inline double grad_dot(int h, double dx, double dy) {
    switch (h & 3) {
        case 0: return dx + dy;
        case 1: return -dx + dy;
        case 2: return dx - dy;
        default: return -dx - dy;
    }
}

static inline double quintic(double t) {
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0);
}

}  // namespace perlin_twin

extern "C" {

void perlin_table_twin(uint32_t seed, uint8_t* out256) {
    perlin_twin::table_from_seed(seed, out256);
}

void perlin_grid_twin(uint32_t seed, const double* xs, const double* ys,
                      int64_t n, double* out);

// Terrain generation fast path (models/chunk.py generate_terrain;
// reference src/voxel/chunk.rs:114-170).  Noise math goes through
// perlin_grid_twin VERBATIM so the bits match the parity-tested path;
// constants mirror utils/config.py (TERRAIN_SCALE 0.01, AMPLITUDE 20,
// DIRT_DEPTH 3).  The Python column-height cache sits above this.
void terrain_heights(uint32_t seed, int64_t px, int64_t pz,
                     int32_t* out1024) {
    double xs[1024], ys[1024], v[1024];
    for (int z = 0; z < 32; z++)
        for (int x = 0; x < 32; x++) {
            xs[z * 32 + x] = (double)(px * 32 + x) * 0.01;
            ys[z * 32 + x] = (double)(pz * 32 + z) * 0.01;
        }
    perlin_grid_twin(seed, xs, ys, 1024, v);
    // Rust `as i32` truncates toward zero == np.trunc().astype(int32)
    for (int i = 0; i < 1024; i++) out1024[i] = (int32_t)(v[i] * 20.0);
}

// heights[z*32+x] + chunk base world-y -> dense blocks u8[z][y][x]
// (grass surface / 3 dirt / stone, chunk.rs:137-158)
void terrain_fill(const int32_t* heights, int32_t wy0, uint8_t* out) {
    for (int z = 0; z < 32; z++) {
        const int32_t* hrow = heights + z * 32;
        for (int y = 0; y < 32; y++) {
            int32_t wy = wy0 + y;
            uint8_t* row = out + (int64_t)(z * 32 + y) * 32;
            for (int x = 0; x < 32; x++) {
                int32_t h = hrow[x];
                row[x] = wy > h ? 0 : (wy == h ? 1 : (wy > h - 3 ? 2 : 3));
            }
        }
    }
}

void perlin_grid_twin(uint32_t seed, const double* xs, const double* ys,
                      int64_t n, double* out) {
    uint8_t t[256];
    perlin_twin::table_from_seed(seed, t);
    auto hash2 = [&](long long xi, long long yi) -> int {
        int a = t[(int)(xi & 0xff)];
        return t[a ^ (int)(yi & 0xff)];
    };
    const double scale = 2.0 / 1.4142135623730951;
    for (int64_t i = 0; i < n; i++) {
        double x = xs[i], y = ys[i];
        double fx = std::floor(x), fy = std::floor(y);
        long long cx = (long long)fx, cy = (long long)fy;
        double dx = x - fx, dy = y - fy;
        double g00 = perlin_twin::grad_dot(hash2(cx, cy), dx, dy);
        double g10 = perlin_twin::grad_dot(hash2(cx + 1, cy), dx - 1.0, dy);
        double g01 = perlin_twin::grad_dot(hash2(cx, cy + 1), dx, dy - 1.0);
        double g11 =
            perlin_twin::grad_dot(hash2(cx + 1, cy + 1), dx - 1.0, dy - 1.0);
        double u = perlin_twin::quintic(dx), v = perlin_twin::quintic(dy);
        double r = g00 + (g10 - g00) * u + (g01 - g00) * v +
                   (g00 + g11 - g10 - g01) * u * v;
        r *= scale;
        if (r > 1.0) r = 1.0;
        if (r < -1.0) r = -1.0;
        out[i] = r;
    }
}

}  // extern "C"
