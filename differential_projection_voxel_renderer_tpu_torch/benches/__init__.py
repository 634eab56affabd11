"""The port's measuring programs, on the card.

- The JAX package's measuring side (``bench.py`` and its ``benches/``
  scripts, which stay the JAX package's): ``bench`` (the headline frames
  a second and its JSON line), ``flythrough_bench``, ``profile_stages``,
  ``micro_project``, ``fly_profile``, ``flythrough_diag``, ``micro_hiz``,
  ``micro_sort``, ``pipeline_experiment``, ``run_benches`` and
  ``kernel_cost_sim`` (the model of K2's Hopper walk), each printing its
  original's lines under their names; ``scene`` builds and caches their
  vd12 scene.
- The cost-probe path: the TPU cost probes of ``benches/micro_fixed.py``,
  ``micro_fixed2.py`` and ``micro_fixed3.py`` as probes of the port's own
  launch path, each keeping its original's variants under their labels
  and driving kernel M1 (``ops.micro.fill_tiles``), M2
  (``ops.micro.blocked_copy``) or, for micro_fixed3's level 3, K2
  (``ops.raster.rasterize_tiles``) on an empty stream; one JSON line per
  variant (``common`` holds what they share).
- ``k1_call``, ``big_quad_cap`` and ``smoke_digests``: K1 and its call
  across two trees, the binnings' big-quad caps on the vd12 flythrough,
  serial, resident and packed, and the digests of ``chip_smoke.py``'s
  serial and packed frames, to compare trees.

Run a module with ``python -m differential_projection_voxel_renderer_tpu_
torch.benches.<module> [arguments]``.  The entry points run on the card
and raise without one; the functions the CPU tests call take
``device="cpu"`` (the plain versions).  Nothing runs when a module is
imported.
"""
