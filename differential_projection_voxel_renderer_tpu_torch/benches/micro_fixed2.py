"""Microbench 2 on the card: the floor of a kernel call with and without
operands, and the host's cost of a launch by operand count.

The port of ``benches/micro_fixed2.py``: its 63 variants under their
labels (``a_base`` .. ``z4_chain4_xla``), built by the counterparts of its
``make`` .. ``make11`` with the original's arguments, plus its ``SOLO10``
operand sweep (a label ``<name>_<n_in>x<n_out>`` is ``make9`` with that
many inputs and outputs).  The fill family launches kernel M1
(``ops.micro.fill_tiles``): colour SKY + x and depth +inf over the 736x1280
frame in 16x(128 * tps) tiles, or the variant's own output shape.  The
copy family (``make9``-``make11``) launches M2 (``ops.micro.blocked_copy``)
over int32 [1024, 128] (the original's grid stepped over [64, 128]
blocks).

How the TPU's knobs map: tile_h, tps, the 2-D grid and the output shape
are the tiles the kernel writes (its CUDA grid is sized for the card:
``ops.micro.FillLayout.plan``, ``copy_grid``); scalar-prefetch arrays,
ANY inputs and metadata arrays are operands passed to the launch, zeros
as in the original; a torch op stands where the original's run function
worked on arrays around its call (``scalars[0] + x``,
``recs.at[23, 0].set(x)``, ``x_in + x``, the XLA ops between chained
calls), counted in the variant's ``torch_ops``.  What has no Hopper
counterpart (VMEM and SMEM scratch that nothing reads, DMA semaphores,
memory-space tags, ``dimension_semantics``, rotating output buffers) is
named in the variant's ``note``; such a variant launches its base form.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.micro_fixed2 [labels]

prints one JSON line per variant, all 63 by default.
"""

from __future__ import annotations

import re
import sys
from functools import partial

import numpy as np

from ..ops import micro
from . import common as C
from .common import H, W, Variant

SRC = "benches/micro_fixed2.py"
ROWS, BR = 1024, 64     # the copy family's [rows, 128] and its block rows
SOLO10 = re.compile(r"[A-Za-z0-9]+_(\d+)x(\d+)")


def _x(x) -> np.ndarray:
    return np.array([x], np.int32)


def _fill(layout, plain, **ops):
    fn = micro.fill_tiles_plain if plain else micro.fill_tiles
    return fn(layout, **ops)


def _copy(plain, *a, **kw):
    fn = micro.blocked_copy_plain if plain else micro.blocked_copy
    return fn(*a, **kw)


def _fill_variant(site, layout, arrays, run, note, has_x=True,
                  torch_ops=(0, 0)) -> Variant:
    return Variant("M1", f"{SRC}:{site}", arrays, run,
                   C.fill_bytes(layout, has_x), layout=layout, note=note,
                   torch_ops=torch_ops)


def make(tile_h=16, tps=2, outs=2, scratch=True, plain=False, grid2d=False):
    """``make`` (kernel :65, pallas_call :106): the output path alone."""
    flags = (micro.DEPTH if outs == 2 else 0) | (
        0 if plain else micro.DEPTH_ADD_X)
    lay = C.frame_layout(tile_h, tps, flags, grid2d)
    note = ("the scratch (VMEM (24, 2*tps*256) and (256, 24) int32) and its "
            "DMA semaphores have no counterpart: nothing reads them, the "
            "kernel reserves no shared memory (b_noscratch's form)"
            if scratch else "")
    if plain:
        note = ("a whole-block store and (8, 128) slice stores are the same "
                "stores here; depth is +inf without x, as in the original")
    if tile_h * (H // tile_h) < H:
        note = (f"the {H // tile_h} tile rows of {tile_h} leave the last "
                f"{H % tile_h} rows unwritten, as in the original")
    return _fill_variant(106, lay, lambda x: {"x": _x(x)},
                         lambda t, p: _fill(lay, p, x=t["x"]), note)


def make2(n_scalar=4, any_input=False, set_copy=False,
          scalar_sizes=(460, 460, 12288, 12288), tk=98304):
    """``make2`` (kernel :130, pallas_call :156): scalar-prefetch arrays
    and an ANY record input, optionally copied with x set each call."""
    lay = C.frame_layout()

    def arrays(x):
        a = {"x": _x(x)}
        a.update((f"s{i}", np.zeros(s, np.int32))
                 for i, s in enumerate(scalar_sizes[:n_scalar]))
        if any_input:
            a["recs"] = np.zeros((24, tk), np.int32)
        return a

    def run(t, plain):
        s0 = t["s0"] + t["x"]          # the original's scalars[0] + x
        extra = [t[f"s{i}"] for i in range(1, n_scalar)]
        if any_input:
            recs = t["recs"]
            if set_copy:               # recs.at[23, 0].set(x)
                recs = recs.clone()
                recs[23, :1] = t["x"]
            extra.append(recs)
        return _fill(lay, plain, x=s0, extra=tuple(extra))

    note = ("x is element 0 of the first scalar array (scalars[0] + x, a "
            "torch add); the other scalar arrays and the records are passed "
            "and not read")
    ops = (1, 8 * scalar_sizes[0] + 4)
    if set_copy:
        note += "; each call copies the records and sets [23, 0] to x"
        ops = (ops[0] + 2, ops[1] + 8 * 24 * tk + 8)
    return _fill_variant(156, lay, arrays, run, note, torch_ops=ops)


def make3(mode):
    """``make3`` (kernel :181, pallas_call :205): metadata as input blocks
    read by each step, x_t = counts[2 * step] + starts[2 * step]."""
    lay = C.frame_layout(flags=micro.DEPTH | micro.DEPTH_ADD_X
                         | micro.X_FROM_META)

    def arrays(x):
        return {"x": _x(x), "starts": np.zeros(460, np.int32),
                "counts": np.zeros(460, np.int32),
                "rows": np.zeros(12288, np.int32),
                "zmin": np.zeros(12288, np.int32)}

    def run(t, plain):
        starts = t["starts"].clone()   # starts.at[0].set(x)
        starts[:1] = t["x"]
        return _fill(lay, plain, starts=starts, counts=t["counts"],
                     extra=(t["rows"], t["zmin"]))

    note = ("the metadata blocks are operands read from global memory; "
            "only step 0 reads starts[0] = x, so only its two tiles show "
            "SKY + x")
    if mode != "smem":
        note += ("; SMEM vs VMEM input blocks have no counterpart: the "
                 "m_smem_meta form")
    return _fill_variant(205, lay, arrays, run, note, has_x=False,
                         torch_ops=(2, 8 * 460 + 8))


def make4(any_sizes=(), smem_scratch=(), extra_sem=False, read_meta=False):
    """``make4`` (kernel :241, pallas_call :274): ANY inputs, SMEM scratch
    and extra semaphores added to the base."""
    read = bool(smem_scratch) and read_meta
    lay = C.frame_layout(flags=micro.DEPTH | micro.DEPTH_ADD_X
                         | (micro.X_PLUS_SCRATCH if read else 0))

    def arrays(x):
        a = {"x": _x(x)}
        a.update((f"a{i}", np.zeros(s, np.int32))
                 for i, s in enumerate(any_sizes))
        return a

    def run(t, plain):
        return _fill(lay, plain, x=t["x"], extra=tuple(
            t[f"a{i}"] for i in range(len(any_sizes))))

    note = ("SMEM scratch and the base's VMEM scratch have no counterpart "
            "where nothing reads them (the kernel reserves no shared "
            "memory); ANY inputs are passed and not read")
    if extra_sem:
        note += "; the extra DMA semaphores have no counterpart: m_base"
    if read:
        note += ("; the original adds SMEM scratch that nothing wrote "
                 "(undefined on the TPU); the port's blocks zero-fill a "
                 "shared word for each step they span and add it, x_t = x")
    return _fill_variant(274, lay, arrays, run, note)


def make5(tps=2, any_sizes=(256,), grid2d=False):
    """``make5`` (kernel :327, pallas_call :350): an ANY input against the
    grid's shape."""
    lay = C.frame_layout(tps=tps, grid2d=grid2d)

    def arrays(x):
        a = {"x": _x(x)}
        a.update((f"a{i}", np.zeros(s, np.int32))
                 for i, s in enumerate(any_sizes))
        return a

    def run(t, plain):
        return _fill(lay, plain, x=t["x"], extra=tuple(
            t[f"a{i}"] for i in range(len(any_sizes))))

    return _fill_variant(350, lay, arrays, run,
                         "ANY inputs are passed and not read")


def make6(space="any", dimsem=None, tps=2):
    """``make6`` (kernel :380, pallas_call :401): ANY vs HBM memory space,
    and dimension_semantics."""
    lay = C.frame_layout(tps=tps)
    note = "the input (256 int32) is passed and not read"
    if space != "any" or dimsem is not None:
        note += (f"; memory space {space!r} and dimension_semantics "
                 f"{dimsem!r} have no counterpart: the k1 form")
    return _fill_variant(
        401, lay, lambda x: {"x": _x(x), "a0": np.zeros(256, np.int32)},
        lambda t, p: _fill(lay, p, x=t["x"], extra=(t["a0"],)), note)


def make7(n_bufs=2, manual_tps=2):
    """``make7`` (kernel :432, pallas_call :501): ANY outputs written by
    manual DMA from VMEM buffers."""
    lay = C.frame_layout(tps=manual_tps,
                         flags=micro.DEPTH | micro.STAGE_TILE)
    note = (f"each block stages its vectors in shared memory (16 bytes a "
            f"thread and output) and stores them from there; the original's "
            f"{n_bufs} rotating tile buffers and their semaphores have no "
            f"counterpart; the metadata input is passed and not read")
    return _fill_variant(
        501, lay, lambda x: {"x": _x(x), "meta": np.zeros(256, np.int32)},
        lambda t, p: _fill(lay, p, x=t["x"], extra=(t["meta"],)), note)


def make8(out_mode="full", any_in=True):
    """``make8`` (kernel :549, pallas_call :571): the output's size and
    shape with an ANY input present."""
    steps = H // 16 * (W // 256)
    if out_mode == "full":
        lay = C.frame_layout(flags=micro.DEPTH)
    elif out_mode == "tiny":
        lay = micro.FillLayout((16, 256), 16, 256, (1, steps),
                               flags=micro.DEPTH | micro.MAP_CONST)
    else:
        lay = micro.FillLayout((H * W,), 1, 16 * 256, (1, steps),
                               flags=micro.DEPTH)
    note = {"full": "", "tiny": "every step writes the same 16x256 block; "
                                "the kernel writes it once, with the last "
                                "step's value",
            "flat1d": "a 1-D output in blocks of 4096"}[out_mode]

    def arrays(x):
        a = {"x": _x(x)}
        if any_in:
            a["a0"] = np.zeros(256, np.int32)
        return a

    def run(t, plain):
        return _fill(lay, plain, x=t["x"],
                     extra=(t["a0"],) if any_in else ())

    return _fill_variant(571, lay, arrays, run,
                         note + "; the ANY input is passed and not read")


def s3_idxmap():
    """``s3_idxmap`` (kernel :605, pallas_call :625): the output block of
    each step read from a prefetched order array."""
    lay = C.frame_layout(flags=micro.DEPTH | micro.DEPTH_ADD_X
                         | micro.MAP_ORDER)
    return _fill_variant(
        625, lay,
        lambda x: {"x": _x(x), "order": np.arange(lay.steps, dtype=np.int32)},
        lambda t, p: _fill(lay, p, x=t["x"], order=t["order"]),
        "block b writes tile order[b]")


def s4_blocked_in():
    """``s4_blocked_in`` (kernel :641, pallas_call :664): a record block
    chosen by a prefetched index each step; x_t = x + its word [0, 0]."""
    lay = C.frame_layout(flags=micro.DEPTH | micro.DEPTH_ADD_X
                         | micro.X_PLUS_REC)

    def arrays(x):
        return {"x": _x(x),
                "bidx": np.arange(lay.steps, dtype=np.int32) % (98304 // 256),
                "recs": np.zeros((24, 98304), np.int32)}

    return _fill_variant(
        664, lay, arrays,
        lambda t, p: _fill(lay, p, x=t["x"], recs=t["recs"], bidx=t["bidx"]),
        "the block reads the word [0, 0] of its record block (the TPU "
        "streamed the whole (24, 256) block into VMEM)")


def make9(n_in=4, n_out=5, rows=ROWS, br=BR):
    """``make9`` (kernel :678, pallas_call :697): operand count with a
    trivial copy body, out_i = in0 + x + i."""
    pairs = tuple((1, i, True) for i in range(n_out))

    def arrays(x):
        a = {"x": _x(x)}
        a.update((f"in{i}", np.zeros((rows, 128), np.int32))
                 for i in range(n_in))
        return a

    def run(t, plain):
        return _copy(plain, [t[f"in{i}"] for i in range(n_in)], t["x"],
                     pairs, block_rows=br)

    return Variant("M2", f"{SRC}:697", arrays, run,
                   C.copy_bytes(rows, n_out), pairs=pairs,
                   note="inputs past in0 are passed and not read")


def make10(alias=False, two_calls=False):
    """``make10`` (kernel :717, pallas_calls :736 and :742): out = in + x,
    out2 = in * 2, in place or twice in a row."""
    pairs = ((1, 0, True), (2, 0, False))

    def run(t, plain):
        a = t["x_in"] + t["x"]
        o = _copy(plain, [a], t["x"], pairs, block_rows=BR,
                  out=(a, None) if alias else None)
        if two_calls:
            o = _copy(plain, [o[0]], t["x"], pairs, block_rows=BR,
                      out=(o[0], None) if alias else None)
        return o

    note = "x_in + x is a torch add before the call"
    if alias:
        note += "; out is written over the input (input_output_aliases)"
    return Variant("M2", f"{SRC}:736", lambda x: {
        "x": _x(x), "x_in": np.zeros((ROWS, 128), np.int32)}, run,
        C.copy_bytes(ROWS, 2) * (1 + two_calls), calls=1 + two_calls,
        pairs=pairs, note=note, torch_ops=(1, C.copy_bytes(ROWS, 1)))


def make11(n_chain=2, xla_between=False, reshape_between=False):
    """``make11`` (kernel :769, pallas_call :782): chained calls, o1 = in
    + x + i, o2 = o1 + 1, optionally with array ops between."""
    pairs = ((1, 0, True), (1, 1, True))

    def run(t, plain):
        a = t["x_in"] + t["x"]
        for i in range(n_chain):
            o = _copy(plain, [a], t["x"] + i, pairs, block_rows=BR)
            a = o[0]
            if xla_between:
                a = a + 1
            if reshape_between:
                a = a.reshape(ROWS * 128).reshape(ROWS, 128)
        return o

    note = ("x_in + x and x + i are torch adds; the ops between calls are "
            "torch ops (a reshape round trip is a view, no copy)")
    xla = n_chain if xla_between else 0
    return Variant("M2", f"{SRC}:782", lambda x: {
        "x": _x(x), "x_in": np.zeros((ROWS, 128), np.int32)}, run,
        C.copy_bytes(ROWS, 2) * n_chain, calls=n_chain, pairs=pairs,
        note=note, torch_ops=(1 + n_chain + xla,
                              C.copy_bytes(ROWS, 1) + 8 * n_chain
                              + xla * 8 * ROWS * 128))


# the original's labels and the calls that build them
VARIANTS = {
    "a_base": partial(make),
    "b_noscratch": partial(make, scratch=False),
    "c_fullrow": partial(make, tps=10, scratch=False),
    "d_tall": partial(make, tile_h=64, scratch=False),
    "e_one_out": partial(make, outs=1, scratch=False),
    "f_plainset": partial(make, plain=True, scratch=False),
    "g_2d_grid": partial(make, grid2d=True, scratch=False),
    "h_scalars4": partial(make2, n_scalar=4, any_input=False),
    "i_scalars4_small": partial(make2, n_scalar=4,
                                scalar_sizes=(460, 460, 512, 512)),
    "j_any": partial(make2, n_scalar=4, any_input=True),
    "k_any_copy": partial(make2, n_scalar=4, any_input=True, set_copy=True),
    "l_scalar1": partial(make2, n_scalar=1, scalar_sizes=(460,)),
    "m_smem_meta": partial(make3, "smem"),
    "n_vmem_meta": partial(make3, "vmem"),
    "o_tinyscalar_any": partial(make2, n_scalar=1, scalar_sizes=(1,),
                                any_input=True),
    "p_tinyscalar_any_copy": partial(make2, n_scalar=1, scalar_sizes=(1,),
                                     any_input=True, set_copy=True),
    "q_tinyscalar_noany": partial(make2, n_scalar=1, scalar_sizes=(1,)),
    "r_460_noany": partial(make2, n_scalar=1, scalar_sizes=(460,)),
    "s_tinyscalar_any_small": partial(make2, n_scalar=1, scalar_sizes=(1,),
                                      any_input=True, tk=1024),
    "m_base": partial(make4),
    "n_any1_small": partial(make4, any_sizes=(460,)),
    "o_any5_big": partial(make4,
                          any_sizes=(460, 460, 12288, 12288, 24 * 98304)),
    "p_smem_small": partial(make4, smem_scratch=(460, 460)),
    "q_smem_big": partial(make4, smem_scratch=(460, 460, 12288, 12288)),
    "r_extra_sem": partial(make4, extra_sem=True),
    "s_smem_read": partial(make4, smem_scratch=(460, 460), read_meta=True),
    "m_base_alone": partial(make4),
    "a_base_after": partial(make),
    "f1_any_big": partial(make4, any_sizes=(24 * 98304,)),
    "f2_any_small": partial(make4, any_sizes=(256,)),
    "f3_smem_small": partial(make4, smem_scratch=(460, 460)),
    "f4_smem_big": partial(make4, smem_scratch=(12288, 12288)),
    "f5_extra_sem": partial(make4, extra_sem=True),
    "f6_any_copy": partial(make2, n_scalar=1, scalar_sizes=(1,),
                           any_input=True, set_copy=True),
    "f7_any_nocopy": partial(make2, n_scalar=1, scalar_sizes=(1,),
                             any_input=True),
    "f8_make2_plain": partial(make2, n_scalar=1, scalar_sizes=(1,)),
    "g1_tps2": partial(make5, tps=2),
    "g2_tps10": partial(make5, tps=10),
    "g3_tps1": partial(make5, tps=1),
    "g4_tps2_2d": partial(make5, tps=2, grid2d=True),
    "g5_tps10_noany": partial(make5, tps=10, any_sizes=()),
    "k1_hbm": partial(make6, space="hbm"),
    "k2_any_par": partial(make6, space="any", dimsem="parallel"),
    "k3_any_arb": partial(make6, space="any", dimsem="arbitrary"),
    "k4_hbm_par": partial(make6, space="hbm", dimsem="parallel"),
    "m1_manual2": partial(make7, n_bufs=2),
    "m2_manual4": partial(make7, n_bufs=4),
    "m3_manual4_tps10": partial(make7, n_bufs=4, manual_tps=10),
    "n1_full": partial(make8, out_mode="full"),
    "n2_tiny": partial(make8, out_mode="tiny"),
    "n3_flat1d": partial(make8, out_mode="flat1d"),
    "n4_big_any_in": partial(make8, out_mode="tiny"),
    "s1_scalar460": partial(make2, n_scalar=1, scalar_sizes=(460,)),
    "s2_scalars4big": partial(make2, n_scalar=4),
    "s3_idxmap": s3_idxmap,
    "s4_blocked_in": s4_blocked_in,
    "y1_noalias": partial(make10),
    "y2_alias": partial(make10, alias=True),
    "y3_two_calls": partial(make10, two_calls=True),
    "z1_chain4": partial(make11, n_chain=4),
    "z2_chain2_xla": partial(make11, n_chain=2, xla_between=True),
    "z3_chain2_reshape": partial(make11, n_chain=2, reshape_between=True),
    "z4_chain4_xla": partial(make11, n_chain=4, xla_between=True),
}
LABELS = tuple(VARIANTS)
# the SOLO10 sweep over operand counts, 1x1 .. 4x5
SWEEP = tuple(f"solo10_{i}x{o}" for i in range(1, 5) for o in range(1, 6))


def variant(label: str) -> Variant:
    """The variant of an original label, or of a SOLO10 label
    ``<name>_<n_in>x<n_out>``; raises KeyError otherwise."""
    if label in VARIANTS:
        return VARIANTS[label]()
    m = SOLO10.fullmatch(label)
    if m is None:
        raise KeyError(f"no micro_fixed2 variant {label!r}")
    return make9(n_in=int(m[1]), n_out=int(m[2]))


def prepare(label: str, x: int = 0, device="cuda", plain: bool = False):
    """The variant's call on ``device`` with its operands made there (the
    card unless ``device="cpu"``): a function of no arguments that returns
    its outputs.  ``plain`` runs the plain PyTorch versions instead of the
    kernels."""
    v = variant(label)
    t = C.tensors(v.arrays(x), device)
    return lambda: v.run(t, plain)


def run_variant(label: str, x: int = 0, device="cuda", plain: bool = False):
    """The variant's outputs for scalar ``x`` (see ``prepare``)."""
    return prepare(label, x, device, plain)()


def time_variant(label: str, x: int = 0) -> dict:
    """The variant's times on the card (``common.measure``)."""
    return C.measure(prepare(label, x))


def main(argv=None) -> int:
    labels = sys.argv[1:] if argv is None else argv
    return C.main_loop(labels, LABELS, time_variant, variant)


if __name__ == "__main__":
    sys.exit(main())
