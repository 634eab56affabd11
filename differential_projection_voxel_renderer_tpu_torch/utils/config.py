"""Global constants and runtime configuration of the voxel renderer.

The port's copy of ``differential_projection_voxel_renderer_tpu/utils/
config.py``, as it is but for the ``use_pallas`` resolution, which needs
JAX; ``RenderConfig`` keeps every field, and the port ignores
``use_pallas``.

Mirrors the tuning points of the Rust reference
(gatewaytofredom/differential_projection_voxel_renderer):

- ``CHUNK_SIZE = 32``                 (src/voxel/chunk.rs:7)
- ``NEAR_W_EPS = 0.001``              (src/rendering/rasterizer.rs:18)
- span epsilon ``0.001`` px           (src/rendering/span_walker.rs:142)
- occlusion epsilon ``0.005``         (src/rendering/occlusion.rs:138)
- occlusion grid ``128 x 72``         (src/main.rs:47)
- ``MACROTILE_SIZE = 128``            (src/rendering/macrotile.rs:21)
- ``PACKET_CAPACITY = 32``            (src/meshing/face_packets.rs:9)
- horizon culling bins/margins        (src/rendering/culling.rs:27-35)

TPU-specific capacities are new here: everything under ``jit`` must have a
static shape, so variable-length quad streams become fixed-capacity buffers
plus counts (see SURVEY.md section 7, "Variable-length quad streams").
"""

from __future__ import annotations

import dataclasses

# --------------------------------------------------------------------------
# Voxel / world constants (reference: src/voxel/chunk.rs:7-9)
# --------------------------------------------------------------------------
CHUNK_SIZE: int = 32
CHUNK_VOLUME: int = CHUNK_SIZE * CHUNK_SIZE * CHUNK_SIZE

# Terrain generation (reference: src/voxel/chunk.rs:114-177)
TERRAIN_SEED: int = 12345
TERRAIN_SCALE: float = 0.01
TERRAIN_AMPLITUDE: float = 20.0
TERRAIN_DIRT_DEPTH: int = 3
TERRAIN_SOLID_MARGIN: int = 10  # "all solid below terrain" margin, chunk.rs:132

# --------------------------------------------------------------------------
# Rasterizer constants
# --------------------------------------------------------------------------
NEAR_W_EPS: float = 0.001           # rasterizer.rs:18
SPAN_EPSILON_PX: float = 0.001      # span_walker.rs:142
MIN_TRIANGLE_AREA: float = 0.1      # rasterizer.rs:2237 (sub-pixel cull)
OCCLUSION_EPSILON: float = 0.005    # occlusion.rs:138
OCCLUSION_GRID_W: int = 128         # main.rs:47
OCCLUSION_GRID_H: int = 72
MACROTILE_SIZE: int = 128           # macrotile.rs:21
PACKET_CAPACITY: int = 32           # face_packets.rs:9
HIZ_BLOCK_SIZE: int = 8             # hiz_buffer.rs:17
SKY_COLOR: int = 0xFF87CEEB         # main.rs:393 framebuffer clear

# --------------------------------------------------------------------------
# TPU static capacities (new; no reference analogue — XLA needs static shapes)
# --------------------------------------------------------------------------
# Max packed quads per chunk mesh.  Terrain chunks average a few hundred
# quads (reference notes ~800 vertices i.e. ~200 quads, binary_greedy.rs:91).
# Worst-case adversarial content (3D checkerboard) overflows any practical
# bound; overflow is reported via a counter, never silent corruption.
QUADS_PER_CHUNK_CAP: int = 4096

# Max chunk meshes drawn in a single frame (reference sees ~250 visible
# meshes at view distance 12, README.md:36).
VISIBLE_CHUNKS_CAP: int = 512

# Max quads gathered from visible chunk meshes per frame (pre-cull).
GATHER_QUADS_CAP: int = 131072  # must stay a power of two: the
# compaction sorts a GATHER_QUADS_CAP-long key array, and a 98304-long
# sort measured ~5 ms slower than 131072 (XLA TPU sort wants pow2)

# Max quads rasterized per frame after culling + compaction.
RENDER_QUADS_CAP: int = 49152  # post-cull cap; sized ~1.3x the vd12
# steady-state survivor count (37k); overflow is counted in stats[2]

# Default framebuffer tile shape for the Pallas rasterizer.  Lane dim must be
# a multiple of 128; sublane dim a multiple of 8 (f32 tiling).  Narrow bands
# spread skewed quad distributions (dense horizon rows) across many tiles,
# keeping per-tile bin lists short.
TILE_H: int = 16    # two sublane groups; see ops/raster.py pick_tile
TILE_W: int = 128   # exactly one lane group (octet-kernel requirement)


@dataclasses.dataclass
class RenderConfig:
    """Per-renderer configuration.

    Mirrors the reference's scattered config structs:
    - WorldConfig            (src/world.rs:10-27)        -> see models/world.py
    - ShadingConfig          (src/rendering/shading.rs)  -> ops/shading.py
    - HorizonCullingConfig   (src/rendering/culling.rs)  -> ops/culling.py
    - MacrotileRenderConfig  (src/rendering/macrotile_renderer.rs:26-40)
    """

    width: int = 1280
    height: int = 720
    enable_shading: bool = True
    enable_textures: bool = True
    backface_culling: bool = True
    # "span mode" draws each quad as its screen-space AABB at constant depth,
    # exactly like the reference Hyper-Pipeline span walker
    # (span_walker.rs:131-193).  The default "exact" mode rasterizes the true
    # projected parallelogram with per-pixel perspective-correct depth/UV,
    # matching the reference's production Pipeline A (rasterizer.rs:1219-1467).
    span_mode: bool = False
    gather_cap: int = GATHER_QUADS_CAP
    quads_cap: int = RENDER_QUADS_CAP
    # flat binned item stream capacity (quad-tile pairs; 256-aligned
    # per-tile segments) — ~1.3 tiles per quad on average, so this bounds
    # item stream cap: ~1.7 items per visible quad at 16x128 tiles
    tile_k_cap: int = 98304
    visible_chunks_cap: int = VISIBLE_CHUNKS_CAP
    tile_h: int = TILE_H
    tile_w: int = TILE_W
    # None => auto (pallas on TPU, jnp elsewhere)
    use_pallas: bool | None = None
    # exact two-pass occlusion (rendering/macrotile.py): render the
    # nearest N quads, build a rendered-depth max pyramid, cull
    # provably-losing far quads before their geometry cost, continue
    # blending onto the near framebuffer.  0 = single pass.  Output is
    # bit-identical either way (tested); worthwhile when occlusion is
    # high and dispatch overhead low.
    two_pass_near_quads: int = 0
    # temporal exact occlusion: on static-camera frames, cull quads
    # against the PREVIOUS frame's rendered-depth max pyramid before
    # their binning/raster cost (rendering/pipeline.py
    # render_prepared_hiz).  Same pyramid test as the two-pass mode but
    # the "near pass" is last frame's finished depth, so the duplicated
    # pipeline cost disappears.  Exact: with camera, world and draw list
    # unchanged, a quad that provably loses against the final depth
    # contributes nothing, so the frame is bit-identical (tested); the
    # engine falls back to the normal step the moment anything changes.
    temporal_hiz: bool = False
    # sub-column-packed raster kernel (ops/raster_packed.py): 4 narrow-quad
    # buckets per [8,128] row evaluation.  Measured SLOWER than the octet
    # kernel at vd12 on v5e (5.2 vs 3.0 ms: the [8,1] coefficient loads
    # dominate once rows shrink, and either segment alignment or straddle
    # handling costs ~1-2 ms) — kept as an opt-in experiment; see NOTES.md.
    packed_raster: bool = False
    # octet-kernel stream knobs (every setting renders the identical
    # frame; see ops/raster.py).  The DPVR_STREAM_GROUP / DPVR_ROW_TREE /
    # DPVR_BLOCK_Q env vars override these at trace time (experiments).
    # - stream_group: adjacent tiles sharing one record-DMA chain
    #   (divides the ~2 us/tile machinery by the group size).  Treated as
    #   a MAX: rasterize_pallas degrades it to the largest value with a
    #   compatible tiles_per_step, so 5 is safe at any frame width.
    # - row_tree: merge-tree row loop (shortens the serial accumulator
    #   chain ~4x at +1.7% row evals).  Measured NEUTRAL-to-worse once
    #   stream_group=5 landed (2.75 vs 2.68 ms) — off by default.
    # - block_q: record DMA block size, clamped to the record capacity.
    # Defaults = the measured v5e/720p/vd12 winner: opi6 + sg5 + bq1024
    # = 2.54 ms vs 2.85 at sg1/bq256 (sweep in NOTES.md round 3).
    stream_group: int = 5
    row_tree: bool = False
    block_q: int = 1024
    # The reference's switch for its per-frame function counters
    # (src/perf/profiling.rs, compiled out unless --features profiling);
    # kept as a field, read by nothing: the port's counters are
    # utils/profiling.py's tracer, switched by DPVR_TRACE.
    profiling: bool = False

