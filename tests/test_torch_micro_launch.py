"""The host side of kernels M1 and M2 (``ops/micro.py``, ``csrc/micro.cu``)
on the CPU: their launch plans, the host parameters the C entry points
read, and the single output buffer of a call.

The kernels run only on the card.  Here each launch is replayed in numpy
from the very parameters the wrapper hands the C entry point
(``FillLayout.c_params``, ``_copy_params``), thread by thread as
``fill_tiles_kernel`` and ``blocked_copy_kernel`` index: which 16-byte
vector each thread stores, and the value.  The replay must write every
element the plain version writes exactly once, 16-byte aligned, with the
plain version's bits, and nothing else; the shared memory a launch asks
for must be what its blocks read.
"""

import itertools

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from differential_projection_voxel_renderer_tpu_torch.benches import common
from differential_projection_voxel_renderer_tpu_torch.benches import (
    micro_fixed as PF,
    micro_fixed2 as PF2,
    micro_fixed3 as PF3,
    probe_call,
)
from differential_projection_voxel_renderer_tpu_torch.ops import micro

MASK = 0xFFFFFFFF


def _i32(v):
    v = np.asarray(v, np.int64) & MASK
    return np.where(v >= 2**31, v - 2**32, v).astype(np.int32)


def _fill_replay(layout, x=None, order=None, starts=None, counts=None,
                 recs=None, bidx=None):
    """fill_tiles_kernel in numpy, from ``layout.c_params``: (colour,
    depth, written mask) over the view, and the scratch words each thread
    reads.  Asserts that no two threads store the same vector and that
    every store is 16-byte aligned."""
    (rows, cols, tile_h, tile_w, tile_rows, steps_x, tps, flags, step0, n4,
     total, scratch_off, scratch_words, blocks, threads,
     smem) = list(layout.c_params)
    g = np.arange(blocks * threads, dtype=np.int64)
    gc = np.minimum(g, total - 1)
    s = gc // n4
    i = gc - s * n4
    b = step0 + s
    xt = np.full(g.shape, int(x[0]) if x is not None else 0, np.int64)
    if flags & micro.X_FROM_META:
        xt = counts[b * tps].astype(np.int64) + starts[b * tps]
    if flags & micro.X_PLUS_REC:
        xt = xt + recs[0, bidx[b].astype(np.int64) * micro.BLOCK_Q]
    word = None
    if flags & micro.X_PLUS_SCRATCH:
        word = s - (g // threads) * threads // n4
        assert word.min() >= 0 and word.max() < scratch_words
    xt = _i32(xt)
    tile = b.copy()
    if flags & micro.MAP_ORDER:
        tile = order[b].astype(np.int64)
    if flags & micro.MAP_CONST:
        tile = np.zeros_like(b)
    ty = np.trunc(tile / steps_x).astype(np.int64)  # C's division
    tx = tile - ty * steps_x
    store = (g < total) & (tile >= 0) & (ty < tile_rows)
    e = 4 * i
    r = e // tile_w
    off = (ty * tile_h + r) * cols + tx * tile_w + (e - r * tile_w)
    off = off[store]
    assert np.all(off % 4 == 0)
    assert len(np.unique(off)) == len(off), "a vector is stored twice"
    colour = np.zeros(rows * cols, np.int32)
    depth = np.zeros(rows * cols, np.float32)
    written = np.zeros(rows * cols, bool)
    lanes = (off[:, None] + np.arange(4)).ravel()
    c = _i32(micro.SKY_I32 + xt.astype(np.int64))[store]
    d = np.full(c.shape, np.inf, np.float32)
    if flags & micro.DEPTH_ADD_X:
        d = d + xt[store].astype(np.float32)
    colour[lanes] = np.repeat(c, 4)
    depth[lanes] = np.repeat(d, 4)
    written[lanes] = True
    shape = (rows, cols)
    return (colour.reshape(shape), depth.reshape(shape),
            written.reshape(shape), word)


def _fill_layouts():
    """(name, layout) of every M1 probe variant, and forms the probes do
    not reach: tiles narrower than a block, a tile height that leaves the
    last rows unwritten, and each read flag with staging."""
    out = {}
    for mod, labels, args in ((PF, PF.LEVELS, ()),
                              (PF2, PF2.LABELS, ()),
                              (PF3, PF3.LABELS, ())):
        for label in labels:
            v = mod.variant(label, *args)
            if v.kernel == "M1":
                out[f"{mod.__name__.rsplit('.', 1)[1]} {label}"] = v.layout
    base = micro.DEPTH | micro.DEPTH_ADD_X
    for name, flags in (("order", micro.MAP_ORDER),
                        ("meta", micro.X_FROM_META),
                        ("rec", micro.X_PLUS_REC),
                        ("scratch", micro.X_PLUS_SCRATCH),
                        ("stage", micro.STAGE_TILE),
                        ("const scratch stage", micro.MAP_CONST
                         | micro.X_PLUS_SCRATCH | micro.STAGE_TILE),
                        ("all reads", micro.X_FROM_META | micro.X_PLUS_REC
                         | micro.X_PLUS_SCRATCH | micro.MAP_ORDER
                         | micro.STAGE_TILE)):
        for tile_h, tile_w, frame in ((16, 256, (64, 512)), (1, 8, (48, 64)),
                                      (3, 4, (48, 64))):
            grid = (1, frame[0] // tile_h * (frame[1] // tile_w))
            out[f"{name} {tile_h}x{tile_w}"] = micro.FillLayout(
                frame, tile_h, tile_w, grid, flags=base | flags,
                tps=max(1, tile_w // 128))
    out["colour only, stage"] = micro.FillLayout(
        (32, 64), 2, 8, (1, 128), flags=micro.STAGE_TILE)
    out["tile_h short of the frame"] = micro.FillLayout(
        (50, 64), 16, 32, (1, 6))
    return out


FILL_LAYOUTS = _fill_layouts()


def _operands(layout, seed):
    rng = np.random.default_rng(seed)
    steps = layout.steps
    n_meta = steps * layout.tps
    cap = 4 * micro.BLOCK_Q
    return dict(
        x=rng.integers(-2**31, 2**31, 1).astype(np.int32),
        order=rng.permutation(steps).astype(np.int32),
        starts=rng.integers(-2**31, 2**31, n_meta).astype(np.int32),
        counts=rng.integers(-2**31, 2**31, n_meta).astype(np.int32),
        recs=rng.integers(-2**31, 2**31, (24, cap)).astype(np.int32),
        bidx=rng.integers(0, cap // micro.BLOCK_Q, steps).astype(np.int32))


@pytest.mark.parametrize("name", sorted(FILL_LAYOUTS))
def test_fill_launch_writes_what_the_plain_version_writes(name):
    """M1's launch, replayed from its host parameters on random operands,
    stores every element of the plain version's tiles once (rows past the
    last whole tile row left unwritten, as ``Variant.written`` and the TPU
    leave them) with the plain version's bits, and nothing else."""
    lay = FILL_LAYOUTS[name]
    ops = _operands(lay, seed=len(name))
    colour, depth, written, _ = _fill_replay(lay, **ops)
    plain = micro.fill_tiles_plain(
        lay, **{k: torch.from_numpy(v) for k, v in ops.items()})
    rows, cols = lay.view
    want = np.zeros((rows, cols), bool)
    tiles = (np.zeros(1, np.int64) if lay.flags & micro.MAP_CONST
             else ops["order"] if lay.flags & micro.MAP_ORDER
             else np.arange(lay.steps))
    for t in tiles:
        ty, tx = divmod(int(t), lay.steps_x)
        if (ty + 1) * lay.tile_h <= rows:
            want[ty * lay.tile_h:(ty + 1) * lay.tile_h,
                 tx * lay.tile_w:(tx + 1) * lay.tile_w] = True
    assert np.array_equal(written, want)
    if not lay.flags & micro.MAP_CONST:
        assert want[:lay.rows_written].all()
    assert not want[lay.rows_written:].any()
    assert np.array_equal(colour[written],
                          plain[0].reshape(rows, cols).numpy()[written])
    if lay.flags & micro.DEPTH:
        assert np.array_equal(
            depth[written].view(np.int32),
            plain[1].reshape(rows, cols).numpy()[written].view(np.int32))


def test_fill_const_map_keeps_the_last_step():
    """MAP_CONST writes tile 0 once, with the last step's value (the TPU's
    grid ran in order), from one step's blocks."""
    lay = micro.FillLayout((32, 64), 4, 16, (1, 32),
                           flags=micro.DEPTH | micro.MAP_CONST
                           | micro.X_FROM_META)
    ops = _operands(lay, seed=9)
    colour, _, written, _ = _fill_replay(lay, **ops)
    last = lay.steps - 1
    assert lay.plan.steps == 1 and lay.plan.blocks == 1
    assert written[:4, :16].all() and written.sum() == 64
    assert (colour[written] == _i32(micro.SKY_I32 + int(ops["counts"][last])
                                    + int(ops["starts"][last]))).all()


@pytest.mark.parametrize("name", sorted(FILL_LAYOUTS))
def test_fill_shared_memory_is_what_a_block_reads(name):
    """A block asks for the shared memory it reads: 16 bytes a thread and
    output with STAGE_TILE, then one word a step it spans with
    X_PLUS_SCRATCH (the most any block spans, each read by its threads),
    and none otherwise."""
    lay = FILL_LAYOUTS[name]
    p = lay.plan
    staged = 0
    if lay.flags & micro.STAGE_TILE:
        staged = 16 * p.threads * (2 if lay.flags & micro.DEPTH else 1)
    _, _, _, word = _fill_replay(lay, **_operands(lay, seed=1))
    words = 0
    if lay.flags & micro.X_PLUS_SCRATCH:
        words = int(word.max()) + 1
        # every word of the span is read by some block
        spans = word.reshape(p.blocks, p.threads).max(axis=1) + 1
        assert spans.max() == p.scratch_words
    assert p.scratch_words == words
    assert (p.smem_bytes, 4 * p.scratch_off) == (staged + 4 * words, staged)
    assert p.smem_bytes <= 48 * 1024
    if not lay.flags & (micro.STAGE_TILE | micro.X_PLUS_SCRATCH):
        assert p.smem_bytes == 0


def test_fill_grid_fills_the_card():
    """The probes' 736x1280 frame is about one wave of 256-thread blocks
    (8 an SM on 132 SMs), not one block a TPU tile."""
    for lay in (PF2.variant("a_base").layout, PF3.variant("h0_base").layout,
                PF2.variant("n3_flat1d").layout):
        p = lay.plan
        assert (p.threads, p.blocks) == (256, 920)
        assert p.blocks == 4 * lay.steps  # 4 blocks a TPU step
        assert p.smem_bytes == 0
    assert PF2.variant("n2_tiny").layout.plan.blocks == 4


def _copy_replay(rows, block_rows, pairs, in0, x):
    """blocked_copy_kernel in numpy, from ``_copy_params``: the outputs
    and how often each vector of each output is stored."""
    p = list(micro._copy_params(rows, block_rows, 1, pairs))
    (rows_p, _, _, n_out, x_mask, blocks, threads), rest = p[:7], p[7:]
    assert rows_p == rows
    mul, add = rest[:micro.MAX_IO], rest[micro.MAX_IO:]
    g = np.arange(blocks * threads)
    g = g[g < rows * 32]
    vec = in0.reshape(-1, 4).astype(np.int64)[g]
    outs, hits = [], []
    for k in range(n_out):
        a = add[k] + (int(x[0]) if (x_mask >> k) & 1 else 0)
        o = np.zeros((rows * 32, 4), np.int32)
        o[g] = _i32(vec * mul[k] + a)
        outs.append(o.reshape(rows, 128))
        hits.append(np.bincount(g, minlength=rows * 32))
    return outs, hits


@pytest.mark.parametrize("rows", [64, 1024, 3 * 64, 17 * 64])
def test_copy_grid_covers_every_vector_once(rows):
    """M2's grid stores every 16-byte vector of every output exactly once,
    at the plain version's values, whatever block_rows (the reference's
    grid step) is; at [1024, 128] it puts every SM to work."""
    rng = np.random.default_rng(rows)
    in0 = rng.integers(-2**31, 2**31, (rows, 128)).astype(np.int32)
    x = np.array([2**31 - 5], np.int32)
    pairs = tuple((1 + k % 3, 7 * k - 3, k % 2 == 0) for k in range(8))
    for br in (64, rows):
        outs, hits = _copy_replay(rows, br, pairs, in0, x)
        ref = micro.blocked_copy_plain([torch.from_numpy(in0)],
                                       torch.from_numpy(x), pairs)
        for o, h, r in zip(outs, hits, ref):
            assert (h == 1).all()
            assert np.array_equal(o, r.numpy())
    blocks, threads = micro.copy_grid(rows)
    assert blocks * threads >= rows * 32 > (blocks - 1) * threads
    if rows == 1024:
        assert blocks >= 132


def test_copy_params_check_the_form():
    with pytest.raises(ValueError):
        micro._copy_params(96, 64, 1, ((1, 0, False),))
    with pytest.raises(ValueError):
        micro._copy_params(64, 64, 9, ((1, 0, False),))
    with pytest.raises(ValueError):
        micro._copy_params(64, 64, 1, ((1, 0, False),) * 9)
    a = micro._copy_params(64, 64, 1, ((1, 0, True), (2, 3, False)))
    assert list(a)[:7] == [64, 64, 1, 2, 1, 16, 128]


def _spans(tensors):
    return sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                  for t in tensors)


def _disjoint_views(tensors):
    spans = _spans(tensors)
    base = tensors[0].untyped_storage().data_ptr()
    return (all(t.untyped_storage().data_ptr() == base for t in tensors)
            and all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
            and all(t.data_ptr() % 16 == 0 for t in tensors))


@pytest.mark.parametrize("label", ["a_base", "e_one_out", "n2_tiny",
                                   "n3_flat1d"])
def test_fill_outputs_are_views_of_one_buffer(label):
    lay = PF2.variant(label).layout
    outs = micro.fill_outputs(lay, "cpu")
    dtypes = [torch.int32, torch.float32][:1 + bool(lay.flags & micro.DEPTH)]
    assert [o.dtype for o in outs] == dtypes
    assert all(tuple(o.shape) == lay.out_shape and o.is_contiguous()
               for o in outs)
    assert _disjoint_views(outs)


@pytest.mark.parametrize("n_out", [1, 5, 8])
def test_copy_outputs_are_views_of_one_buffer(n_out):
    in0 = torch.zeros((192, 128), dtype=torch.int32)
    outs = micro.copy_outputs(in0, n_out)
    assert len(outs) == n_out
    assert all(o.shape == in0.shape and o.dtype == torch.int32
               and o.is_contiguous() for o in outs)
    assert _disjoint_views(outs)
    assert not any(o.untyped_storage().data_ptr()
                   == in0.untyped_storage().data_ptr() for o in outs)


def test_copy_outputs_use_what_out_gives():
    in0 = torch.zeros((64, 128), dtype=torch.int32)
    given = torch.ones((64, 128), dtype=torch.int32)
    for out in ((in0, None, None), (None, given, None), (in0, given)):
        outs = micro.copy_outputs(in0, len(out), out)
        for o, g in zip(outs, out):
            if g is not None:
                assert o is g
        new = [o for o, g in zip(outs, out) if g is None]
        if new:
            assert _disjoint_views(new)
    for bad in (torch.zeros((64, 64), dtype=torch.int32),
                torch.zeros((64, 128), dtype=torch.int64),
                torch.zeros((128, 64), dtype=torch.int32).t()):
        with pytest.raises(ValueError):
            micro.copy_outputs(in0, 1, (bad,))
    with pytest.raises(ValueError):
        micro.copy_outputs(in0, 2, (None,))


class _CountOps(TorchDispatchMode):
    """(launches, bytes) of the torch ops run under it: every op that is
    not a view, its tensor operands read once (an in-place op's first
    written, not read) and its results written once."""

    def __init__(self):
        super().__init__()
        self.launches = self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            read = args[1:] if func._schema.name.endswith("_") else args
            self.launches += 1
            self.bytes += sum(t.numel() * t.element_size() for t in
                              pytree.tree_leaves((read, out))
                              if isinstance(t, torch.Tensor))
        return out


@pytest.mark.parametrize("module", ["micro_fixed", "micro_fixed2",
                                    "micro_fixed3"])
def test_variants_count_their_torch_ops(module, monkeypatch):
    """Each variant's ``torch_ops`` are the launches and bytes of the torch
    ops its run makes around its kernel calls (the kernels stubbed out)."""
    mod, labels, args = {
        "micro_fixed": (PF, PF.LEVELS, ()),
        "micro_fixed2": (PF2, PF2.LABELS + PF2.SWEEP, (3,)),
        "micro_fixed3": (PF3, PF3.LABELS[:3] + PF3.H_VARIANTS, ())}[module]
    monkeypatch.setattr(micro, "fill_tiles_plain", lambda lay, **k: ())
    monkeypatch.setattr(micro, "blocked_copy_plain",
                        lambda inputs, x, pairs, **k: (inputs[0],) * len(
                            pairs))
    for label in labels:
        v = mod.variant(label)
        inputs = mod.build_inputs() if module != "micro_fixed2" else None
        t = common.tensors(v.arrays(*args) if inputs is None
                           else v.arrays(inputs), "cpu")
        with _CountOps() as ops:
            v.run(t, True)
        assert (ops.launches, ops.bytes) == v.torch_ops, label


def test_fill_layouts_combine_flags():
    """Every combination of the value flags plans a launch the C entry
    point accepts (threads 256, shared memory under 48 KiB)."""
    names = ("MAP_ORDER", "MAP_CONST", "X_FROM_META", "X_PLUS_SCRATCH",
             "X_PLUS_REC", "STAGE_TILE", "DEPTH")
    for bits in itertools.product((0, 1), repeat=len(names)):
        flags = sum(getattr(micro, n) for n, on in zip(names, bits) if on)
        lay = micro.FillLayout((32, 64), 2, 8, (1, 128), flags=flags)
        p = lay.plan
        assert p.threads == 256 and 0 <= p.smem_bytes <= 48 * 1024
        assert len(lay.c_params) == 16


def test_probe_call_derives_floor_and_bound():
    """benches/probe_call.py's derived columns: the bound is the bytes over
    the HBM rate, launches x floor + bound counts the kernel's launches,
    and the torch ops' launches and bytes where the run makes them."""
    mods = probe_call.modules(build=False)
    floor = 0.0013
    rows = {}
    for label, graph in (("a_base", 0.0040), ("z4_chain4_xla", 0.0200),
                         ("solo10_4x5", 0.0020)):
        rows["micro_fixed2", label] = dict(
            graph_ms=graph, run_ms=0.03, library_ms=0.04,
            kernel=PF2.variant(label).kernel)
    probe_call.derive(rows, floor, mods)
    a = rows["micro_fixed2", "a_base"]
    assert a["bytes"] == 736 * 1280 * 8 + 4
    assert a["bound_ms"] == pytest.approx(a["bytes"] / 3.35e9)
    assert a["floor_bound_ms"] == pytest.approx(floor + a["bound_ms"])
    assert a["run_floor_bound_ms"] == pytest.approx(a["floor_bound_ms"])
    assert a["within_floor"] is False and a["near"] and a["beats_library"]
    z = rows["micro_fixed2", "z4_chain4_xla"]
    assert (z["torch_launches"], z["floor_bound_ms"] > 4 * floor) == (9, True)
    assert z["run_floor_bound_ms"] > z["floor_bound_ms"] + 9 * floor
    counts = probe_call.summary(rows, floor)
    assert counts["M1"]["variants"] == 1 and counts["M2"]["variants"] == 2
    assert counts["M2"]["within"] == 1
