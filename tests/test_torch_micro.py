"""The cost-probe path (``differential_projection_voxel_renderer_tpu_torch
.benches``, kernels M1 and M2) against the TPU cost probes
``benches/micro_fixed.py``, ``micro_fixed2.py`` and ``micro_fixed3.py`` on
the CPU.

The JAX bench modules are loaded by path (``benches/`` is not a package)
with their ``PHASE*``/``SOLO*``/``H_VARIANTS`` variables cleared, so that
nothing runs at import.  Their kernels run through ``pl.pallas_call`` in
interpret mode.  A micro_fixed2 variant is built by the very statement of
the original that builds it under its label (found in the module's syntax
tree), with the module's ``timeit`` patched to hand back the jitted
function.  Both sides get the same inputs, made with numpy from a seed
(x for micro_fixed2, the five arrays for micro_fixed and micro_fixed3),
and the port's plain versions must equal the JAX kernels bit for bit,
colour and depth, over every element the kernel writes.

Left out: ``s_smem_read``, whose original adds SMEM scratch that nothing
wrote to x (undefined on the TPU; interpret mode gives garbage, one colour
2139606766); the port zero-fills that scratch.  micro_fixed3's level 3
(the real raster on an empty stream) runs at a 128x256 frame: interpreted
at 736x1280 it takes about a minute.
"""

import ast
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from differential_projection_voxel_renderer_tpu_torch.benches import common
from differential_projection_voxel_renderer_tpu_torch.benches import (
    micro_fixed as PF,
    micro_fixed2 as PF2,
    micro_fixed3 as PF3,
)
from differential_projection_voxel_renderer_tpu_torch.ops import micro

BENCHES = os.path.join(os.path.dirname(__file__), "..", "benches")
MF2_CASES = (
    "a_base", "c_fullrow", "d_tall", "e_one_out", "f_plainset", "g_2d_grid",
    "m_smem_meta", "k2_any_par", "m1_manual2", "n2_tiny", "n3_flat1d",
    "s3_idxmap", "s4_blocked_in", "solo10_4x5", "y1_noalias", "y2_alias",
    "y3_two_calls", "z2_chain2_xla", "z3_chain2_reshape",
)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", os.path.join(BENCHES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jb():
    """The JAX bench modules, imported with nothing run at import."""
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith(("PHASE", "SOLO", "H_VARIANTS")):
                mp.delenv(k)
        return {n: _load(n) for n in
                ("micro_fixed", "micro_fixed2", "micro_fixed3")}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _tree(mod):
    with open(mod.__file__) as f:
        return ast.parse(f.read())


def _is_label_test(node, label=None):
    """``v == "<label>"`` (the SOLO blocks' branches)."""
    return (isinstance(node, ast.Compare) and isinstance(node.left, ast.Name)
            and node.left.id == "v" and len(node.comparators) == 1
            and isinstance(node.comparators[0], ast.Constant)
            and (label is None or node.comparators[0].value == label))


def _label_statements(tree, label):
    """The original's statements that build ``label``: the body of its
    ``if v == label`` branch, else the call that names it first."""
    for node in ast.walk(tree):
        if isinstance(node, ast.If) and _is_label_test(node.test, label):
            return node.body
    for node in ast.walk(tree):
        if (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)
                and node.value.args
                and isinstance(node.value.args[0], ast.Constant)
                and node.value.args[0].value == label):
            return [node]
    raise KeyError(label)


def _original_labels(tree):
    """Every label micro_fixed2.py times: the first argument of a make*
    call, and each ``v == ...`` of its SOLO blocks."""
    labels = set()
    for node in ast.walk(tree):
        if _is_label_test(node):
            labels.add(node.comparators[0].value)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id.startswith("make") and node.args
              and isinstance(node.args[0], ast.Constant)):
            labels.add(node.args[0].value)
    return labels


def _jax_mf2(mod, label, monkeypatch):
    """The jitted run function of the original's variant ``label``."""
    got = {}
    monkeypatch.setattr(mod, "timeit",
                        lambda fn, lab, k=30: got.setdefault(lab, fn))
    m = PF2.SOLO10.fullmatch(label)
    if m:
        mod.make9(label, n_in=int(m[1]), n_out=int(m[2]))
    else:
        stmts = _label_statements(_tree(mod), label)
        exec(compile(ast.Module(body=stmts, type_ignores=[]), mod.__file__,
                     "exec"), mod.__dict__)
    return got[label]


def _torch_outs(outs):
    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    return [torch.from_numpy(np.array(o)) for o in outs]


def _assert_same(v, port, ref):
    port, ref = v.written(port), v.written(_torch_outs(ref))
    assert common.same_bits(port, ref), [
        (np.unique(a.numpy())[:4], np.unique(b.numpy())[:4])
        for a, b in zip(port, ref)]


@pytest.mark.parametrize("label", MF2_CASES)
def test_micro_fixed2_matches_jax(jb, interpret, monkeypatch, label):
    mod = jb["micro_fixed2"]
    x = int(np.random.default_rng(len(label)).integers(-2**31, 2**31))
    ref = _jax_mf2(mod, label, monkeypatch)(jnp.int32(x))
    v = PF2.variant(label)
    port = PF2.run_variant(label, x, device="cpu")
    _assert_same(v, port, ref)
    if v.kernel == "M1":
        assert len(port) == (2 if v.layout.flags & micro.DEPTH else 1)


def _jax_inputs(inputs):
    return [jnp.asarray(inputs[k]) for k in PF3.INPUTS]


@pytest.mark.parametrize("level", [0, 2])
def test_micro_fixed_matches_jax(jb, interpret, level):
    inputs = PF.build_inputs(seed=level + 1)
    assert inputs["counts"].any()
    ref = jb["micro_fixed"].build(level)(*_jax_inputs(inputs))
    port = PF.run_variant(level, inputs, device="cpu")
    _assert_same(PF.variant(level), port, ref)


@pytest.mark.parametrize("label", ["0", "1", "2", "h0_base", "h4_one_input"])
def test_micro_fixed3_matches_jax(jb, interpret, label):
    mod = jb["micro_fixed3"]
    inputs = PF3.build_inputs(seed=7)
    build = mod.build_h if label.startswith("h") else mod.build
    ref = build(label if label.startswith("h") else int(label))(
        *_jax_inputs(inputs))
    port = PF3.run_variant(label, inputs, device="cpu")
    _assert_same(PF3.variant(label), port, ref)


def test_micro_fixed3_level3_matches_jax(jb, monkeypatch):
    """K2 on an empty stream (the original's rasterize_pallas, interpreted)
    at a 128x256 frame of the original's 720-row NDC."""
    mod = jb["micro_fixed3"]
    monkeypatch.setattr(mod, "H", 128)
    monkeypatch.setattr(mod, "W", 256)
    monkeypatch.setattr(mod.R, "rasterize_pallas", functools.partial(
        mod.R.rasterize_pallas, interpret=True))
    frame = (128, 256)
    inputs = PF3.build_inputs(frame=frame)
    ref = mod.build(3)(*_jax_inputs(inputs))
    port = PF3.run_variant("3", inputs, device="cpu", frame=frame)
    _assert_same(PF3.variant("3", frame), port, ref)
    assert bool((port[0] == micro.SKY_I32).all())
    assert bool(torch.isinf(port[1]).all())


def test_every_label_has_a_port_variant(jb):
    """All 63 labels of micro_fixed2.py, the SOLO10 sweep, micro_fixed's
    levels and micro_fixed3's levels and h variants resolve to a port
    variant of the original's kernel family and call site."""
    labels = _original_labels(_tree(jb["micro_fixed2"]))
    assert len(labels) == 63 and labels == set(PF2.LABELS)
    for label in PF2.LABELS:
        v = PF2.variant(label)
        assert v.kernel in ("M1", "M2") and v.site.startswith(
            "benches/micro_fixed2.py:")
    for label in PF2.SWEEP:
        n_in, n_out = map(int, label.split("_")[1].split("x"))
        v = PF2.variant(label)
        assert (v.kernel, len(v.pairs)) == ("M2", n_out)
        assert len(PF2.run_variant(label, 3, device="cpu")) == n_out
    with pytest.raises(KeyError):
        PF2.variant("no_such_label")
    assert [PF.variant(lv).site for lv in PF.LEVELS] == [
        "benches/micro_fixed.py:93"] * 3
    sites = {PF3.variant(lab).site for lab in PF3.LABELS}
    assert sites == {"benches/micro_fixed3.py:86",
                     "benches/micro_fixed3.py:117",
                     "benches/micro_fixed3.py:207"}
    h = next(n for n in ast.walk(_tree(jb["micro_fixed3"]))
             if isinstance(n, ast.Tuple) and n.elts
             and isinstance(n.elts[0], ast.Constant)
             and n.elts[0].value == "h0_base")
    assert tuple(e.value for e in h.elts) == PF3.H_VARIANTS


def _fill_reference(layout, x, order, starts, counts, recs, bidx):
    """A loop over the blocks, in numpy, of what M1 writes."""
    rows, cols = layout.view
    colour = np.zeros((rows, cols), np.int64)
    depth = np.zeros((rows, cols), np.float32)
    for b in range(layout.steps):
        xt = int(x[0])
        if layout.flags & micro.X_FROM_META:
            xt = int(counts[b * layout.tps]) + int(starts[b * layout.tps])
        if layout.flags & micro.X_PLUS_REC:
            xt += int(recs[0, bidx[b] * micro.BLOCK_Q])
        xt = (xt + 2**31) % 2**32 - 2**31
        tile = int(order[b]) if layout.flags & micro.MAP_ORDER else b
        r0 = tile // layout.steps_x * layout.tile_h
        c0 = tile % layout.steps_x * layout.tile_w
        sl = np.s_[r0:r0 + layout.tile_h, c0:c0 + layout.tile_w]
        colour[sl] = (micro.SKY_I32 + xt + 2**31) % 2**32 - 2**31
        depth[sl] = np.float32(np.inf) + np.float32(xt)
    return colour.astype(np.int32), depth


@pytest.mark.parametrize("flag", ["X_FROM_META", "X_PLUS_REC", "MAP_ORDER"])
def test_fill_plain_reads_its_operands(flag):
    """M1's plain version against a loop over the blocks, on random
    operands (the probes' own are mostly zeros)."""
    rng = np.random.default_rng(3)
    lay = common.frame_layout(flags=micro.DEPTH | micro.DEPTH_ADD_X
                              | getattr(micro, flag), frame=(64, 512))
    ops = dict(x=rng.integers(-2**31, 2**31, 1).astype(np.int32),
               order=rng.permutation(lay.steps).astype(np.int32),
               starts=rng.integers(-2**31, 2**31, 64).astype(np.int32),
               counts=rng.integers(-2**31, 2**31, 64).astype(np.int32),
               recs=rng.integers(-2**31, 2**31, (24, 4096)).astype(np.int32),
               bidx=rng.integers(0, 16, lay.steps).astype(np.int32))
    colour, depth = micro.fill_tiles_plain(
        lay, **{k: torch.from_numpy(v) for k, v in ops.items()})
    ref = _fill_reference(lay, **ops)
    assert np.array_equal(colour.numpy(), ref[0])
    assert np.array_equal(depth.numpy().view(np.int32), ref[1].view(np.int32))


def test_copy_plain_wraps_and_writes_in_place():
    """M2's plain version against numpy on random int32 (sums wrap), and
    its in-place form."""
    rng = np.random.default_rng(5)
    a = rng.integers(-2**31, 2**31, (128, 128)).astype(np.int32)
    x = np.array([2**31 - 3], np.int32)
    pairs = ((1, 0, True), (2, 5, False), (1, 7, True))
    outs = micro.blocked_copy_plain([torch.from_numpy(a)],
                                    torch.from_numpy(x), pairs)
    for (m, add, ax), o in zip(pairs, outs):
        want = (a.astype(np.int64) * m + add + (int(x[0]) if ax else 0))
        want = ((want + 2**31) % 2**32 - 2**31).astype(np.int32)
        assert np.array_equal(o.numpy(), want)
    buf = torch.from_numpy(a.copy())
    got = micro.blocked_copy_plain([buf], torch.from_numpy(x), pairs,
                                   out=(buf, None, None))
    assert got[0] is buf and torch.equal(buf, outs[0])
    assert torch.equal(got[1], outs[1])


def test_fill_layout_refuses_what_the_card_cannot_hold():
    """Tiles that 16-byte stores cannot write (a width that is not a
    multiple of 4) or that do not fit the frame."""
    with pytest.raises(ValueError):
        micro.FillLayout((64, 120), 16, 6, (1, 20))
    with pytest.raises(ValueError):
        micro.FillLayout((64, 1280), 16, 384, (1, 12))
    with pytest.raises(ValueError):
        common.frame_layout(tile_h=1024)


def test_cost_probes_run_on_the_card_by_default():
    """The entry points default to the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for run in (lambda: PF2.run_variant("a_base"),
                lambda: PF.run_variant(0), lambda: PF3.run_variant("3")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    with pytest.raises(RuntimeError):
        PF2.time_variant("a_base")
