"""differential_projection_voxel_renderer_tpu_torch -- the voxel renderer's
default frame path in PyTorch, with hand-written CUDA kernels for Hopper.

A port of ``differential_projection_voxel_renderer_tpu`` (JAX/Pallas),
which stays the reference it is tested against.  The host layers (world,
camera, chunks, meshing, culling, shading tables) are imported from the
reference package; this package owns everything that runs on the device:

- ``ops``       -- projection and coefficients, kernel K1 (stage A,
                   ``ops/geometry.py`` + ``csrc/geometry.cu``), tile
                   binning and kernel K2 (the tile raster, ``ops/raster.py``
                   + ``csrc/raster.cu``); each kernel has a plain PyTorch
                   twin that runs for CPU tensors
- ``rendering`` -- the render step and the Renderer (``pipeline.py``), and
                   the frame parity gates (``parity.py``)
- ``app``       -- QuadPool, Engine, FrameResult (``engine.py``)

The kernels build with nvcc at first use (``_build.py``).  The package
imports torch and never jax.
"""

__version__ = "0.1.0"
