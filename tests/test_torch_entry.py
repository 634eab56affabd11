"""The port's graft entry points (``graft_entry``) and parity self-tests
on the CPU.

- ``_example_scene`` equals ``__graft_entry__._example_scene`` exactly:
  pool, counts, positions, slot count and camera.
- ``entry(device="cpu", width=256, height=128)`` against
  ``__graft_entry__.entry()``: the example tensors and keywords exact, the
  JAX step's raster inputs (its Pallas path in interpret mode) as
  tests/test_torch_pipeline.py holds them, and the frame from them bit for
  bit (``test_entry_matches_jax`` gives the detail).
- ``dryrun_multichip(n, device="cpu")`` for n = 1, 2, 4, 8: its own
  checks, the stacked bands equal to the single-camera step bit for bit
  among them.
- ``run_selftests`` and ``run_production_parity`` on the CPU, where the
  kernels' wrappers run the same plain twins: both report "exact".
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as JG
from differential_projection_voxel_renderer_tpu.rendering import pipeline as JPL
from differential_projection_voxel_renderer_tpu_torch import graft_entry as TG
from differential_projection_voxel_renderer_tpu_torch.parallel import (
    sharded_render as TSR,
)
from differential_projection_voxel_renderer_tpu_torch.rendering import (
    parity as TPAR,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [{}, dict(pool_slots=16, qcap=512,
                                         n_chunks=4)])
def test_example_scene_matches_jax(kw):
    ref, got = JG._example_scene(**kw), TG._example_scene(**kw)
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(r, g)
        assert r.dtype == g.dtype
    assert ref[3] == got[3] > 0
    np.testing.assert_array_equal(ref[4].view_projection_matrix(),
                                  got[4].view_projection_matrix())
    np.testing.assert_array_equal(ref[4].position, got[4].position)


def _allclose_nan(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_allclose(a[ok], b[ok], rtol=rtol, atol=0)


def test_entry_matches_jax():
    """The port's forward step and example tensors against the JAX
    entry's.  The example tensors are exact.  The JAX step, run on its
    Pallas path (as on the TPU, where it bins: at 256x128 the 2048-item
    cap drops 535 items, which the jnp path, never binning, does not),
    gives the raster inputs: the binning intermediates are exact, the near
    depth row and the octet suffix-min within 1e-4 relative (its geometry
    kernel's interpret-mode lowering, tests/test_torch_pipeline.py).  Its
    records, rasterized by K2's twin, give the port's frame bit for bit;
    the stats match the port's own count of dropped items."""
    from differential_projection_voxel_renderer_tpu_torch.ops import (
        raster as TR,
    )

    fn, args = TG.entry(device="cpu", width=256, height=128)
    jfn, jargs = JG.entry()
    assert all(a.device.type == "cpu" for a in args)
    for a, b in zip(jargs, args):
        b = b.numpy()
        np.testing.assert_array_equal(
            np.asarray(a), b.view(np.uint32) if b.dtype == np.int32
            and b.ndim == 1 else b)
    for k in ("tile_h", "tile_w", "render_cap", "tile_k_cap",
              "backface_culling"):
        assert fn.keywords[k] == jfn.keywords[k], k
    color, depth, stats = fn(*args)
    assert color.shape == depth.shape == (128, 256)
    rec2 = fn(*args, debug_return_records=True)
    kw = dict(jfn.keywords, width=256, height=128, use_pallas=True,
              interpret=True, debug_return_records=True)
    rec1 = [np.asarray(x) for x in JPL._render_step(*jargs, **kw)]
    for i in (1, 2, 3):  # tile starts, tile counts, octet rows
        np.testing.assert_array_equal(rec1[i], rec2[i].numpy())
    records1, records2 = rec1[0], rec2[0].numpy()
    np.testing.assert_array_equal(records1[:21], records2[:21])
    np.testing.assert_array_equal(records1[22:], records2[22:])
    _allclose_nan(records1[21].view(np.float32),
                  records2[21].view(np.float32), 1e-4)
    _allclose_nan(rec1[4], rec2[4].numpy(), 1e-4)
    c1, d1 = TR.rasterize_tiles_plain(
        *(torch.from_numpy(np.array(x)) for x in rec1),
        height=128, width=256, tile_h=16, tile_w=128, out_h=128)
    assert torch.equal(c1, color) and torch.equal(d1, depth)
    st = stats.tolist()
    assert st[0] == int(args[2]) and st[2] == 0 and st[3] == 535, st
    assert (color.numpy().view(np.uint32) != np.uint32(0xFF87CEEB)).sum(
    ) > 2000


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip(n):
    """The (dp, tp) layout of make_mesh(n) on the CPU; its checks include
    the stacked bands against the single-camera step, bit for bit."""
    assert tuple(TSR.make_mesh(n, devices=["cpu"] * n)) == {
        1: (1, 1), 2: (1, 2), 4: (2, 2), 8: (2, 4)}[n]
    mesh = TG.dryrun_multichip(n, device="cpu")
    assert mesh.flat == [torch.device("cpu")] * n


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.dryrun_multichip(4)


def test_selftests_on_the_cpu():
    assert TPAR.run_selftests(device="cpu") == (
        "fuzz@128x128: exact | fuzz@640x128: exact | pipelined@640x128: "
        "exact | fused-insert@640x128: exact | resident-append@640x128: "
        "exact")


def test_production_parity_on_the_cpu():
    from differential_projection_voxel_renderer_tpu_torch.rendering import (
        pipeline as TPL,
    )
    from differential_projection_voxel_renderer_tpu_torch.utils.config import (
        RenderConfig,
    )

    _fn, args = TG.entry(device="cpu", width=256, height=128)
    renderer = TPL.Renderer(RenderConfig(width=256, height=128,
                                         gather_cap=16384, quads_cap=8192),
                            device="cpu")
    verdict = TPAR.run_production_parity(renderer, args[:3], args[3],
                                         args[4].numpy())
    assert verdict.startswith("exact (256x128, "), verdict
    assert "kernels K1+K2 vs plain twins on cpu" in verdict


def test_demo_writes_a_ppm(tmp_path, capsys):
    """The port's demo at a small size on the CPU: the PPM is its header
    and 3 W H bytes, equal to the returned frame; ``--span`` renders the
    same pose in span mode."""
    from differential_projection_voxel_renderer_tpu_torch.examples import (
        render_demo,
    )

    out = tmp_path / "frame.ppm"
    fb = render_demo.main([str(out), "--vd", "1", "--width", "128",
                           "--height", "64", "--device", "cpu"])
    data = out.read_bytes()
    header = b"P6\n128 64\n255\n"
    assert data[:len(header)] == header
    assert data[len(header):] == fb.to_rgb8().tobytes()
    assert len(data) == len(header) + 3 * 128 * 64
    assert (fb.color != np.uint32(0xFF87CEEB)).sum() > 0
    assert "wrote" in capsys.readouterr().out
    span = render_demo.main([str(out), "--vd", "1", "--width", "128",
                             "--height", "64", "--span", "--device", "cpu"])
    data = out.read_bytes()
    assert data[len(header):] == span.to_rgb8().tobytes()
    # span mode draws flat block colours: its frame differs from the
    # textured one where the terrain shows
    drawn = span.color != np.uint32(0xFF87CEEB)
    assert drawn.sum() > 0 and (span.color != fb.color).any()
