"""The renderer's constants that the reference needs (the values of the
port's ``utils/config.py`` at commit 1521963; the reference's own source,
gatewaytofredom/differential_projection_voxel_renderer, gives each)."""

CHUNK_SIZE = 32                 # src/voxel/chunk.rs:7
TERRAIN_SEED = 12345            # src/voxel/chunk.rs:114
TERRAIN_SCALE = 0.01
TERRAIN_AMPLITUDE = 20.0
TERRAIN_DIRT_DEPTH = 3
TERRAIN_SOLID_MARGIN = 10       # src/voxel/chunk.rs:132
NEAR_W_EPS = 0.001              # src/rendering/rasterizer.rs:18
MIN_TRIANGLE_AREA = 0.1         # src/rendering/rasterizer.rs:2237
SPAN_EPSILON_PX = 0.001         # src/rendering/span_walker.rs:142
SKY_COLOR = 0xFF87CEEB          # src/main.rs:393
