"""The cost-probe path: the TPU cost probes of ``benches/micro_fixed.py``,
``micro_fixed2.py`` and ``micro_fixed3.py`` as probes of the port's own
launch path on the card.

Each module keeps its original's variants under their labels and drives
kernel M1 (``ops.micro.fill_tiles``), M2 (``ops.micro.blocked_copy``) or,
for micro_fixed3's level 3, K2 (``ops.raster.rasterize_tiles``) on an
empty stream.  Entry points run on the card unless given ``device="cpu"``
(the plain versions) and raise without one; timing needs the card.  Run a
module with ``python -m differential_projection_voxel_renderer_tpu_torch.
benches.<module> [labels]``: one JSON line per variant.  Nothing runs when
a module is imported.
"""
