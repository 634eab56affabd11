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
// and the chunk occlusion pre-pass (src/rendering/occlusion.rs:60-154),
// and the frame funnel's draw-list stage, which runs the horizon cull
// (funnel_pass), and the packing of a frame's upload (pack_frame).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

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

// Squared distance of a mesh centre from the camera, the key of the
// front-to-back order: ops/culling.py sort_front_to_back's float32
// (d * d).sum(-1), whose reduction adds the three terms left to right.
static inline float sort_key(const float* c, const float* cam) {
    const float dx = c[0] - cam[0];
    const float dy = c[1] - cam[1];
    const float dz = c[2] - cam[2];
    return (dx * dx + dy * dy) + dz * dz;
}

// The keys of n centres f32[n][3] into out f32[n] (meshing/native_bridge.py
// checks them against numpy's before it offers funnel_pass).
void funnel_sort_keys(const float* centers, int64_t n, const float* cam,
                      float* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = sort_key(centers + 3 * i, cam);
}

// The frame funnel from the chunk table to the draw list, in one pass
// (app/engine.py Engine._funnel_native; its numpy twin is
// Engine._funnel_numpy, equal bit for bit):
//   table:   i64[n][3] chunk positions (the world's table order)
//   dots:    f32[n][6] each chunk's min corner dotted with the six plane
//            normals (numpy's product, Frustum.plane_terms), or null: no
//            frustum test; off: f32[6] the planes' offsets for a 32-cube
//   vd2:     the squared view distance around the camera's chunk, < 0:
//            no sphere test
//   keys, key_slots, n_keys: the pool's used positions packed 21 bits an
//            axis, sorted, and their slots (QuadPool.lookup_table)
//   join:    i32[n] or null: each table row's slot, -1 where it has none,
//            -2 where not yet known (found from the keys and written)
//   counts i32[S], counts6 i32[S][6], positions i32[S][3]: the pool's
//            host tables
//   cam_x, cam_y, cam_z: the camera position
//   horizon: nonzero: the horizon cull with bins .. min_dist_chunks
//   dir_mask: nonzero: the face-direction keep mask, else all ones
//   vcap:    the draw list's rows
// Writes into out, in this order: vis i64[n][3] (the chunks kept, table
// order), missing i64[n][3] (those with no pool slot), and all vcap rows
// of slots i32[vcap], counts6 i32[vcap][6], dir masks i32[vcap][6] and
// positions i32[vcap][3] (rows past the list 0, masks 1); and sizes
// i64[4]: the chunks kept, missing, meshed (non-empty, before the
// horizon cull), and the draw list's length.
void funnel_pass(const int64_t* table, int64_t n, const float* dots,
                 const float* off, int64_t vd2, const int64_t* keys,
                 const int32_t* key_slots, int64_t n_keys, int32_t* join,
                 const int32_t* counts, const int32_t* counts6,
                 const int32_t* positions, float cam_x, float cam_y,
                 float cam_z, int32_t horizon, int32_t bins,
                 float base_margin, float margin_dist_factor,
                 float min_dist_chunks, int32_t dir_mask, int64_t vcap,
                 uint8_t* out, int64_t* sizes) {
    const float chunk_size = 32.0f;
    const float cam[3] = {cam_x, cam_y, cam_z};
    // the camera's chunk, models/world.py world_to_chunk_pos (the division
    // by a power of two is exact)
    int64_t cam_chunk[3];
    for (int a = 0; a < 3; ++a)
        cam_chunk[a] = (int64_t)std::floor(cam[a] / chunk_size);
    int64_t* vis = (int64_t*)out;
    int64_t* missing = vis + 3 * n;
    int32_t* slots_out = (int32_t*)(missing + 3 * n);
    int32_t* counts6_out = slots_out + vcap;
    int32_t* mask_out = counts6_out + 6 * vcap;
    int32_t* positions_out = mask_out + 6 * vcap;
    std::vector<int32_t> slots;
    std::vector<float> centers;
    slots.reserve(vcap);
    centers.reserve(3 * vcap);
    const int64_t b = int64_t(1) << 20;
    int64_t n_vis = 0, n_missing = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* p = table + 3 * i;
        if (vd2 >= 0) {
            const int64_t dx = p[0] - cam_chunk[0];
            const int64_t dy = p[1] - cam_chunk[1];
            const int64_t dz = p[2] - cam_chunk[2];
            if (dx * dx + dy * dy + dz * dz > vd2) continue;
        }
        if (dots) {
            const float* d = dots + 6 * i;
            bool inside = true;
            for (int k = 0; k < 6; ++k) inside &= (d[k] + off[k]) >= 0.0f;
            if (!inside) continue;
        }
        std::memcpy(vis + 3 * n_vis, p, 3 * sizeof(int64_t));
        ++n_vis;
        int32_t s = join ? join[i] : -2;
        if (s == -2) {
            const int64_t q =
                ((p[0] + b) << 42) | ((p[1] + b) << 21) | (p[2] + b);
            const int64_t* at = std::lower_bound(keys, keys + n_keys, q);
            s = (at == keys + n_keys || *at != q) ? -1 : key_slots[at - keys];
            if (join) join[i] = s;
        }
        if (s < 0) {
            std::memcpy(missing + 3 * n_missing, p, 3 * sizeof(int64_t));
            ++n_missing;
            continue;
        }
        if (counts[s] <= 0) continue;
        slots.push_back(s);
        for (int a = 0; a < 3; ++a)
            centers.push_back((float)p[a] * chunk_size + 16.0f);
    }
    const int64_t m = (int64_t)slots.size();
    std::vector<float> key(m), sorted(3 * m);
    std::vector<int64_t> order(m);
    for (int64_t i = 0; i < m; ++i) {
        key[i] = sort_key(&centers[3 * i], cam);
        order[i] = i;
    }
    const float* kp = key.data();
    std::stable_sort(order.begin(), order.end(),
                     [kp](int64_t x, int64_t y) { return kp[x] < kp[y]; });
    for (int64_t i = 0; i < m; ++i)
        std::memcpy(&sorted[3 * i], &centers[3 * order[i]], 3 * sizeof(float));
    std::vector<uint8_t> keep(m, 1);
    if (horizon && m)
        horizon_cull(sorted.data(), m, cam, bins, base_margin,
                     margin_dist_factor, min_dist_chunks, chunk_size,
                     keep.data());
    int64_t r = 0;
    for (int64_t i = 0; i < m && r < vcap; ++i) {
        if (!keep[i]) continue;
        const int32_t s = slots[order[i]];
        slots_out[r] = s;
        std::memcpy(counts6_out + 6 * r, counts6 + 6 * (int64_t)s,
                    6 * sizeof(int32_t));
        const int32_t* ps = positions + 3 * (int64_t)s;
        std::memcpy(positions_out + 3 * r, ps, 3 * sizeof(int32_t));
        int32_t* mk = mask_out + 6 * r;
        for (int a = 0; a < 3; ++a) {
            const float lo = (float)ps[a] * chunk_size;
            mk[2 * a] = dir_mask ? (int32_t)(cam[a] > lo + 1.0f) : 1;
            mk[2 * a + 1] = dir_mask ? (int32_t)(cam[a] < lo + 31.0f) : 1;
        }
        ++r;
    }
    for (int64_t i = r; i < vcap; ++i) {
        slots_out[i] = 0;
        for (int k = 0; k < 6; ++k) {
            counts6_out[6 * i + k] = 0;
            mask_out[6 * i + k] = 1;
        }
        for (int a = 0; a < 3; ++a) positions_out[3 * i + a] = 0;
    }
    sizes[0] = n_vis;
    sizes[1] = n_missing;
    sizes[2] = m;
    sizes[3] = r;
}

// A draw list's one host-to-device upload, written where the caller says
// (rendering/pipeline.py Renderer._frame_of; its numpy twin is
// _pack_frame, equal word for word):
//   slots:     i32[rows] pool slots
//   counts:    i32[rows][6] quads by face direction, or with per_dir 0
//              i32[rows] totals (one direction-0 unit a chunk)
//   mask:      i32[rows][6] face directions kept, or null: all kept
//   positions: i32[rows][3] chunk positions
//   vcap:      the draw list's rows in the upload (rows <= vcap)
//   view_proj, cam_pos: f32[16], f32[3], or null: no camera
//   payload:   payload_words u32 (the insert payload), or null
// Writes into out: the 11-short meta over vcap rows (slots, counts6, the
// mask's six bits, positions, each as int16; rows past `rows` zero),
// padded with a zero short to whole words, then the camera's 19 floats,
// then the payload.  Returns the quads of the kept directions, or
// PACK_OUT_OF_RANGE where a slot or a coordinate lies outside int16.
static const int64_t PACK_OUT_OF_RANGE = INT64_MIN;

int64_t pack_frame(const int32_t* slots, const int32_t* counts,
                   int32_t per_dir, const int32_t* mask,
                   const int32_t* positions, int64_t rows, int64_t vcap,
                   const float* view_proj, const float* cam_pos,
                   const uint32_t* payload, int64_t payload_words,
                   int32_t* out) {
    const int64_t n_meta = (11 * vcap + 1) / 2;
    int16_t* meta = (int16_t*)out;
    std::memset(out, 0, n_meta * sizeof(int32_t));
    int64_t total = 0;
    for (int64_t r = 0; r < rows; ++r) {
        const int32_t* p = positions + 3 * r;
        if (slots[r] > 32767) return PACK_OUT_OF_RANGE;
        for (int a = 0; a < 3; ++a)
            if (p[a] > 32767 || p[a] < -32767) return PACK_OUT_OF_RANGE;
        meta[r] = (int16_t)slots[r];
        int64_t bits = 0;
        for (int d = 0; d < 6; ++d) {
            const int64_t c = per_dir ? counts[6 * r + d]
                                      : (d ? 0 : counts[r]);
            const int32_t m = mask ? mask[6 * r + d] : 1;
            meta[vcap + 6 * r + d] = (int16_t)c;
            // numpy's int16 shift, then its sum
            bits += (int16_t)((int16_t)m << d);
            total += c * m;
        }
        meta[7 * vcap + r] = (int16_t)bits;
        for (int a = 0; a < 3; ++a)
            meta[8 * vcap + 3 * r + a] = (int16_t)p[a];
    }
    int32_t* w = out + n_meta;
    if (view_proj) {
        std::memcpy(w, view_proj, 16 * sizeof(float));
        std::memcpy(w + 16, cam_pos, 3 * sizeof(float));
        w += 19;
    }
    if (payload) std::memcpy(w, payload, payload_words * sizeof(uint32_t));
    return total;
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
