"""The port's projection ops and kernel K1's plain twin against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages: fuzzed
quad words over all six faces and every u/v/w/h range, and the fuzz
chunk's real mesh, under three cameras -- one inside a chunk, so that both
``any_behind`` and ``all_behind`` occur.

Tolerances.  The port equals the JAX package's XLA form of stage A
(``project_and_cull``) bit for bit on every field, K1's twin included.
The Pallas geometry kernel run in interpret mode lowers the same jnp code
through a differently shaped XLA:CPU program whose LLVM backend contracts
some multiply-adds into FMAs (README "One caveat"), so it differs from its
own XLA form: ``depth_near`` (a quotient of two cancelling sums) by up to
a few hundred ulps, measured 3.1e-5 relative, and the bbox by one pixel on
quads that are culled anyway.  Against it the test therefore holds
``valid``, ``bby``, ``subpixel`` and the bbox of every valid quad exact and
``depth_near`` to 1e-4 relative.

The port boxes a quad that straddles the near plane by its visible part
where that is bounded (``ops/projection.py`` ``STRADDLE_MARGIN``), where the
reference boxes it as the whole screen; the tests against the JAX package
run at the reference's boxes (the margin set to infinity, which bounds no
side), and ``test_stage_a_bounds_straddling_quads`` holds the port's boxes
to the reference's everywhere else.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from differential_projection_voxel_renderer_tpu.meshing.greedy import mesh_chunk
from differential_projection_voxel_renderer_tpu.models.camera import Camera
from differential_projection_voxel_renderer_tpu.ops import geometry_pallas as G
from differential_projection_voxel_renderer_tpu.ops import projection as JP
from differential_projection_voxel_renderer_tpu.ops.shading import (
    build_quad_color_tables,
)
from differential_projection_voxel_renderer_tpu.ops.texture import TextureAtlas
from differential_projection_voxel_renderer_tpu.rendering import parity
from differential_projection_voxel_renderer_tpu_torch.ops import geometry as TG
from differential_projection_voxel_renderer_tpu_torch.ops import projection as TP

W, H = 256, 128
N = 4096
N_QUADS = 3500  # stream length: the tail is out of stream

CAMERAS = {
    "above": ([16.0, 48.0, 16.0], [16.0, 8.0, 16.0]),
    "inside": ([5.0, 5.0, 5.0], [40.0, 0.0, 20.0]),
    "far": ([10.0, 60.0, 90.0], [0.0, 0.0, 0.0]),
}


def _fuzz_words(rng, n):
    f = [rng.integers(0, hi, n) for hi in (32, 32, 64, 64, 4, 32, 6)]
    u, v, w, h, blk, sl, face = f
    return (u | (v << 5) | (w << 10) | (h << 16) | (blk << 22) | (sl << 24)
            | (face << 29)).astype(np.uint32)


def _streams():
    rng = np.random.default_rng(1234)
    fuzz = _fuzz_words(rng, N)
    fuzz_w = (rng.integers(-2, 2, (3, N)) * 32).astype(np.float32)
    mesh = mesh_chunk(parity.fuzz_chunk())
    chunk = np.zeros(N, np.uint32)
    chunk[:len(mesh)] = mesh
    return {"fuzz": (fuzz, fuzz_w),
            "fuzz_chunk": (chunk, np.zeros((3, N), np.float32))}


STREAMS = _streams()


def _camera(name):
    pos, tgt = CAMERAS[name]
    cam = Camera(np.asarray(pos, np.float32), W / H)
    cam.look_at(np.asarray(tgt, np.float32))
    return (cam.view_projection_matrix().astype(np.float32),
            cam.position.astype(np.float32))


@pytest.fixture
def reference_boxes(monkeypatch):
    """Stage A boxes every straddling quad as the whole screen, as the
    reference does."""
    monkeypatch.setattr(TP, "STRADDLE_MARGIN", float("inf"))


def _jax_world(qw):
    return tuple(jnp.asarray(qw[a]) for a in range(3))


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_decode_quads_matches_jax(stream):
    words, _ = STREAMS[stream]
    ref = JP.decode_quads(jnp.asarray(words))
    got = TP.decode_quads(TP.as_quad_words(words))
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(v), got[k].numpy(), err_msg=k)


@pytest.mark.parametrize("cam", sorted(CAMERAS))
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_stage_a_matches_jax_bit_exact(stream, cam, reference_boxes):
    words, qw = STREAMS[stream]
    vp, cp = _camera(cam)
    in_stream = np.arange(N) < N_QUADS
    ref = JP.project_and_cull(
        jnp.asarray(words), _jax_world(qw), jnp.asarray(in_stream),
        JP.view_tables(jnp.asarray(vp), jnp.asarray(cp)), width=W, height=H)
    got = TP.project_and_cull(
        TP.as_quad_words(words), tuple(torch.from_numpy(qw)),
        torch.from_numpy(in_stream), torch.from_numpy(vp),
        torch.from_numpy(cp), width=W, height=H)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(ref[k]), v.numpy(),
                                      err_msg=k)
    if stream == "fuzz" and cam == "inside":
        behind = got["any_behind"].numpy()
        assert behind.any() and not behind.all()
        assert not got["valid"].numpy()[behind].all()  # some fully behind


def _assert_twin_matches_geometry_kernel(stream, cam, subpixel_culling):
    words, qw = STREAMS[stream]
    vp, cp = _camera(cam)
    ref = G.project_cull_pallas(
        jnp.asarray(words), _jax_world(qw), N_QUADS, jnp.asarray(vp),
        jnp.asarray(cp), width=W, height=H, interpret=True,
        subpixel_culling=subpixel_culling)
    got = TG.project_cull(
        TP.as_quad_words(words), torch.from_numpy(qw), N_QUADS,
        torch.from_numpy(vp), torch.from_numpy(cp), width=W, height=H,
        subpixel_culling=subpixel_culling)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("valid", "bby", "subpixel"):
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    valid = got["valid"]
    np.testing.assert_array_equal(ref["bbx"][valid], got["bbx"][valid])
    for part in (lambda b: b & 0xFFFF, lambda b: b >> 16):
        assert np.abs(part(ref["bbx"]) - part(got["bbx"])).max() <= 1
    np.testing.assert_allclose(ref["depth_near"], got["depth_near"],
                               rtol=1e-4, atol=0)
    assert valid.sum() > 100
    # ... while the twin is bit-exact against the XLA form of the same math
    xla = JP.project_and_cull(
        jnp.asarray(words), _jax_world(qw), jnp.arange(N) < N_QUADS,
        JP.view_tables(jnp.asarray(vp), jnp.asarray(cp)), width=W, height=H,
        subpixel_culling=subpixel_culling)
    xla = {k: np.asarray(v) for k, v in xla.items()}
    np.testing.assert_array_equal(xla["valid"], got["valid"])
    np.testing.assert_array_equal(xla["bb_x0"] | (xla["bb_x1"] << 16),
                                  got["bbx"])
    np.testing.assert_array_equal(xla["bb_y0"] | (xla["bb_y1"] << 16),
                                  got["bby"])
    np.testing.assert_array_equal(xla["depth_near"], got["depth_near"])
    np.testing.assert_array_equal(xla["subpixel"], got["subpixel"])
    return ref, got


@pytest.mark.parametrize("cam", sorted(CAMERAS))
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_stage_a_bounds_straddling_quads(stream, cam):
    """At the port's boxes every field equals the reference's (the JAX
    package's XLA stage A) but the boxes of the quads that straddle the
    near plane, each of which lies in the reference's whole screen; the
    camera inside a chunk bounds most of them."""
    words, qw = STREAMS[stream]
    vp, cp = _camera(cam)
    in_stream = np.arange(N) < N_QUADS
    ref = JP.project_and_cull(
        jnp.asarray(words), _jax_world(qw), jnp.asarray(in_stream),
        JP.view_tables(jnp.asarray(vp), jnp.asarray(cp)), width=W, height=H)
    got = TP.project_and_cull(
        TP.as_quad_words(words), tuple(torch.from_numpy(qw)),
        torch.from_numpy(in_stream), torch.from_numpy(vp),
        torch.from_numpy(cp), width=W, height=H)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    box = ("bb_x0", "bb_x1", "bb_y0", "bb_y1")
    for k in got:
        if k not in box:
            np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    behind = got["any_behind"]
    straddles = behind & got["valid"]
    for k in box:
        np.testing.assert_array_equal(ref[k][~behind], got[k][~behind],
                                      err_msg=k)
    assert (got["bb_x0"] >= 0).all() and (got["bb_x1"] <= W - 1).all()
    assert (got["bb_y0"] >= 0).all() and (got["bb_y1"] <= H - 1).all()
    area = ((got["bb_x1"] - got["bb_x0"] + 1)
            * (got["bb_y1"] - got["bb_y0"] + 1))
    # the reference's straddling boxes are the whole screen
    assert (ref["bb_x1"][behind] - ref["bb_x0"][behind] == W - 1).all()
    if stream == "fuzz" and cam == "inside":
        assert (area[straddles] < W * H).sum() > straddles.sum() // 2 > 10


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_project_cull_twin_matches_geometry_kernel(cam, reference_boxes):
    """K1's twin vs the Pallas geometry kernel in interpret mode (see the
    module note for the two contracted fields)."""
    _assert_twin_matches_geometry_kernel("fuzz", cam, True)


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_project_cull_twin_without_subpixel_culling(cam, reference_boxes):
    """``subpixel_culling=False``: no quad is sub-pixel and the tiny quads
    stay valid, in the twin as in the Pallas kernel, on the fuzz chunk's
    mesh (the far camera sees 867 of its quads as sub-pixel)."""
    _, got = _assert_twin_matches_geometry_kernel("fuzz_chunk", cam, False)
    assert not got["subpixel"].any()
    culling = TG.project_cull(
        TP.as_quad_words(STREAMS["fuzz_chunk"][0]),
        torch.from_numpy(STREAMS["fuzz_chunk"][1]), N_QUADS,
        *(torch.from_numpy(x) for x in _camera(cam)), width=W, height=H)
    # the quads the default culls as sub-pixel are exactly the ones added
    np.testing.assert_array_equal(
        got["valid"], culling["valid"].numpy()
        | culling["subpixel"].numpy().astype(bool))


@pytest.mark.parametrize("skip", [1024, 2500])
def test_project_cull_twin_skip_matches_geometry_kernel(skip, reference_boxes):
    """``skip_quads`` drops the stream's head, as a Python int and as a
    device scalar, like the Pallas kernel's skip argument."""
    words, qw = STREAMS["fuzz"]
    vp, cp = _camera("above")
    ref = G.project_cull_pallas(
        jnp.asarray(words), _jax_world(qw), N_QUADS, jnp.asarray(vp),
        jnp.asarray(cp), width=W, height=H, interpret=True, skip_quads=skip)
    t_args = (TP.as_quad_words(words), torch.from_numpy(qw), N_QUADS,
              torch.from_numpy(vp), torch.from_numpy(cp))
    full = TG.project_cull(*t_args, width=W, height=H)["valid"].numpy()
    for s in (skip, torch.tensor(skip, dtype=torch.int32)):
        got = TG.project_cull(*t_args, width=W, height=H, skip_quads=s)
        got = {k: v.numpy() for k, v in got.items()}
        valid = got["valid"]
        np.testing.assert_array_equal(np.asarray(ref["valid"]), valid)
        np.testing.assert_array_equal(valid, full & (np.arange(N) >= skip))
        for k in ("bby", "subpixel"):
            np.testing.assert_array_equal(np.asarray(ref[k]), got[k],
                                          err_msg=k)
        np.testing.assert_array_equal(np.asarray(ref["bbx"])[valid],
                                      got["bbx"][valid])
    assert full[:skip].any() and valid[skip:].any()


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_quad_coefficients_match_jax(cam):
    words, qw = STREAMS["fuzz_chunk"]
    vp, cp = _camera(cam)
    tables = build_quad_color_tables(TextureAtlas().kernel_tables())
    ref = JP.quad_coefficients(
        jnp.asarray(words), _jax_world(qw), None,
        JP.view_tables(jnp.asarray(vp), jnp.asarray(cp)), tables,
        width=W, height=H)
    got = TP.quad_coefficients(
        TP.as_quad_words(words), tuple(torch.from_numpy(qw)),
        torch.from_numpy(vp), TP.color_table_tensors(tables, "cpu"))
    assert set(ref) == set(got)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(ref[k]), v.numpy(),
                                      err_msg=k)


def test_pack_tilebox_matches_jax():
    rng = np.random.default_rng(5)
    b = {k: rng.integers(0, 1280 if "x" in k else 720, 512).astype(np.int32)
         for k in ("bb_x0", "bb_x1", "bb_y0", "bb_y1")}
    ref = JP.pack_tilebox({k: jnp.asarray(v) for k, v in b.items()},
                          tile_h=16, tile_w=128)
    got = TP.pack_tilebox(*(torch.from_numpy(b[k]) for k in
                            ("bb_x0", "bb_x1", "bb_y0", "bb_y1")),
                          tile_h=16, tile_w=128)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("gq", [4096, 4093])
def test_kernel_outputs_are_disjoint_views_of_one_buffer(gq):
    """K1's outputs: the reference's dtypes and shapes, the two counts as
    adjacent i32 scalars, every view in one storage and none overlapping
    another, the pointers the C entry takes in its order; each call a
    fresh buffer."""
    out = TG.kernel_outputs(gq, "cpu")
    want = dict(valid=torch.bool, bbx=torch.int32, bby=torch.int32,
                depth_near=torch.float32, subpixel=torch.int32,
                subpix_total=torch.int32, valid_count=torch.int32)
    assert list(out) == list(want)
    storage = out["bbx"].untyped_storage()
    base = storage.data_ptr()
    spans = []
    for k, dtype in want.items():
        v = out[k]
        assert v.dtype == dtype and v.is_contiguous(), k
        assert v.shape == (() if k in ("subpix_total", "valid_count")
                           else (gq,)), k
        assert v.untyped_storage().data_ptr() == base, k
        lo = v.data_ptr()
        spans.append((lo, lo + v.numel() * v.element_size()))
    spans.sort()
    assert spans[0][0] >= base and spans[-1][1] <= base + storage.nbytes()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert TG.output_ptrs(out) == tuple(
        out[k].data_ptr() for k in ("valid", "bbx", "bby", "depth_near",
                                    "subpixel", "subpix_total"))
    assert out["valid_count"].data_ptr() == out["subpix_total"].data_ptr() + 4
    if gq % 4 == 0:  # the kernel's 16-byte accesses
        assert all(p % 16 == 0 for p in TG.output_ptrs(out)[:5])
    again = TG.kernel_outputs(gq, "cpu")
    assert again["bbx"].untyped_storage().data_ptr() != base


@pytest.mark.parametrize("subpixel_culling", [True, False])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_project_cull_counts_match_sums(stream, subpixel_culling):
    """The twin's two counts are the sums of its outputs and of the Pallas
    kernel's (interpret mode) on the same stream, under the far camera."""
    words, qw = STREAMS[stream]
    vp, cp = _camera("far")
    got = TG.project_cull_plain(
        TP.as_quad_words(words), torch.from_numpy(qw), N_QUADS,
        torch.from_numpy(vp), torch.from_numpy(cp), width=W, height=H,
        subpixel_culling=subpixel_culling)
    assert got["subpix_total"].dtype == got["valid_count"].dtype == (
        torch.int32)
    assert int(got["subpix_total"]) == int(got["subpixel"].sum())
    assert int(got["valid_count"]) == int(got["valid"].sum())
    ref = G.project_cull_pallas(
        jnp.asarray(words), _jax_world(qw), N_QUADS, jnp.asarray(vp),
        jnp.asarray(cp), width=W, height=H, interpret=True,
        subpixel_culling=subpixel_culling)
    assert int(got["subpix_total"]) == int(jnp.sum(ref["subpixel"]))
    assert int(got["valid_count"]) == int(jnp.sum(ref["valid"]))
    assert int(got["subpix_total"]) == (
        867 if subpixel_culling and stream == "fuzz_chunk" else 0)
