"""differential_projection_voxel_renderer_tpu_torch -- the voxel renderer's
frame paths and application surface in PyTorch, with hand-written CUDA
kernels for Hopper.

A port of ``differential_projection_voxel_renderer_tpu`` (JAX/Pallas),
which stays the reference it is tested against.  The port imports nothing
of it; it keeps its own copies of the reference's jax-free host layers,
under the same sub-package names:

- ``utils``, ``models``, ``meshing`` (with ``native/src``, the C++ mesher,
  built at first use into ``build/native/``), ``ops/culling.py``,
  ``ops/occlusion.py``, ``ops/shading.py``, ``ops/texture.py``,
  ``rendering/framebuffer.py``, ``rendering/oracle.py`` -- world, camera,
  chunks, meshing, culling and shading tables, the host framebuffer and
  the f64 oracles, as in the reference
- ``ops``       -- projection and coefficients, kernel K1 (stage A,
                   ``ops/geometry.py`` + ``csrc/geometry.cu``), tile
                   binning, kernel K2 (the tile raster) and kernel K3 (the
                   raster with the next frame's stage A, frames in flight;
                   ``ops/raster.py`` + ``csrc/raster.cu``), the packed
                   binning and kernel K4 (the packed tile raster;
                   ``ops/raster_packed.py`` + ``csrc/raster_packed.cu``);
                   each kernel has a plain PyTorch twin that runs for CPU
                   tensors
- ``rendering`` -- the render step and the Renderer (``pipeline.py``), and
                   the frame parity gates and self-tests (``parity.py``)
- ``app``       -- QuadPool, Engine, FrameResult (``engine.py``), the
                   flythrough (``flythrough.py``)
- ``parallel``  -- row bands and the camera batch over a mesh of cards
                   (``sharded_render.py``)
- ``graft_entry`` -- the graft entry points ``entry`` and
                   ``dryrun_multichip``; ``examples/render_demo.py`` -- the
                   headless demo

The kernels build with nvcc at first use (``_build.py``).  The entry
points run on the card unless the caller passes ``device="cpu"``.  The
package imports torch and never jax.
"""

__version__ = "0.1.0"
