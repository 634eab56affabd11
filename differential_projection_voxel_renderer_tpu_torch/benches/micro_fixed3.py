"""Microbench 3 on the card: bisect the tile raster's empty-stream floor.

The port of ``benches/micro_fixed3.py``: its ``kernel`` (:40,
pallas_call :117) and ``build_h``'s ``k`` (:181, pallas_call :207) as
kernel M1, and its level 3, the real raster, as the port's K2
(``ops.raster.rasterize_tiles``) with zero tile counts.  The frame is
736x1280 (a 720-row image padded to the tile), 460 tiles of 16x128, two a
block; colour SKY, depth +inf.

- level 0: the constant frame only;
- level 1: + the one-time copy of the four metadata arrays (starts,
  counts [460], rows [12288] int32, zmin [12288] float32) into SMEM at
  grid step 0;
- level 2: + each tile's starts and counts read, and its first record
  block staged in VMEM when its count is positive;
- level 3: K2 on the empty stream (``rasterize_pallas`` in the original).
The copy and the stage of levels 1-2 decide no value: they have no
counterpart, and those levels launch level 0's form.

The ``h`` variants bisect the operand and scratch sets of level 0:
``h0_base`` (five inputs, all scratch), ``h1_static_recs`` (the same call;
the original's timing loop varied starts instead of the records),
``h2_no_oct_scratch`` (without the two octet arrays' scratch),
``h3_vmem_oct`` (the octet scratch in VMEM rather than SMEM),
``h4_one_input`` (starts only).

Operands are the original's five (ANY inputs there), all passed to the
launch.  Its scratch -- SMEM starts, counts [460], rows, zmin [12288] and
the VMEM records (24, 2*2*256) and (256, 24) int32, 219.6 KiB -- and its
DMA semaphores have no counterpart: nothing reads them, and the kernel
reserves no shared memory, so the h variants differ in their operands
only.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.micro_fixed3 [labels]
"""

from __future__ import annotations

import sys

import numpy as np

from ..ops import micro, raster
from . import common as C

LEVELS = ("0", "1", "2", "3")
H_VARIANTS = ("h0_base", "h1_static_recs", "h2_no_oct_scratch",
              "h3_vmem_oct", "h4_one_input")
LABELS = LEVELS + H_VARIANTS
SRC = "benches/micro_fixed3.py"
INPUTS = ("starts", "counts", "rows", "zmin", "recs")


def build_inputs(seed=None, frame=(C.H, C.W)) -> dict:
    """The original's operands for a frame (out_h, width) as numpy
    arrays: zeros (zmin +inf) as its ``main`` makes them, or, with a
    ``seed``, random tile counts whose segments tile the record stream."""
    n_tiles = frame[0] // C.TILE_H * (frame[1] // 128)
    counts = np.zeros(n_tiles, np.int32)
    if seed is not None:
        counts = np.random.default_rng(seed).integers(
            0, 200, n_tiles).astype(np.int32)
    return {"starts": (np.cumsum(counts) - counts).astype(np.int32),
            "counts": counts, "rows": np.zeros(C.N_OCT, np.int32),
            "zmin": np.full(C.N_OCT, np.inf, np.float32),
            "recs": np.zeros((24, C.TK), np.int32)}


def variant(label, frame=(C.H, C.W)) -> C.Variant:
    label = str(label)
    if label not in LABELS:
        raise KeyError(f"no micro_fixed3 variant {label!r}")
    n_tiles = frame[0] // C.TILE_H * (frame[1] // 128)
    if label == "3":
        kw = dict(height=C.HEIGHT, width=frame[1], tile_h=C.TILE_H,
                  tile_w=128, out_h=frame[0])

        def run3(t, plain):
            fn = (raster.rasterize_tiles_plain if plain
                  else raster.rasterize_tiles)
            return fn(t["recs"], t["starts"], t["counts"], t["rows"],
                      t["zmin"], **kw)

        return C.Variant(
            "K2", f"{SRC}:86", lambda inputs: inputs, run3,
            frame[0] * frame[1] * 8 + n_tiles * 8,
            note="the port's K2 (ops/raster.py rasterize_tiles) for "
                 "rasterize_pallas, zero counts")
    lay = C.frame_layout(flags=micro.DEPTH, frame=frame)
    n_in = 1 if label == "h4_one_input" else 5
    scratch = ("the scratch has no counterpart (nothing reads it): "
               "h0_base's call")
    notes = {
        "h1_static_recs": "the same call as h0_base (the original's timing "
                          "loop varied starts instead of the records)",
        "h2_no_oct_scratch": scratch,
        "h3_vmem_oct": scratch,
        "1": "the metadata copy decided no value and has no counterpart: "
             "level 0's form",
        "2": "the metadata copy and the record stage decided no value and "
             "have no counterpart: level 0's form",
    }

    def run(t, plain):
        fn = micro.fill_tiles_plain if plain else micro.fill_tiles
        ops = dict(zip(("starts", "counts", "meta_rows", "meta_zmin",
                        "recs"), (t[k] for k in INPUTS[:n_in])))
        return fn(lay, **ops)

    site = 207 if label.startswith("h") else 117
    return C.Variant("M1", f"{SRC}:{site}", lambda inputs: inputs, run,
                     C.fill_bytes(lay, has_x=False), layout=lay,
                     note=notes.get(label, ""))


def prepare(label, inputs=None, device="cuda", plain: bool = False,
            frame=(C.H, C.W)):
    """The variant's call on ``device`` (the card unless
    ``device="cpu"``) for a frame (out_h, width), with ``inputs``
    (``build_inputs(frame=frame)`` by default) made there: a function of no
    arguments that returns (colour, depth).  ``plain`` runs the plain
    PyTorch versions instead of the kernels."""
    v = variant(label, frame)
    if inputs is None:
        inputs = build_inputs(frame=frame)
    t = C.tensors(v.arrays(inputs), device)
    return lambda: v.run(t, plain)


def run_variant(label, inputs=None, device="cuda", plain: bool = False,
                frame=(C.H, C.W)):
    """The variant's (colour, depth) (see ``prepare``)."""
    return prepare(label, inputs, device, plain, frame)()


def time_variant(label, inputs=None) -> dict:
    """The variant's times on the card (``common.measure``)."""
    return C.measure(prepare(label, inputs))


def main(argv=None) -> int:
    labels = sys.argv[1:] if argv is None else argv
    return C.main_loop(labels, LABELS, time_variant, variant)


if __name__ == "__main__":
    sys.exit(main())
