"""Microbench 1 on the card: where does an empty tile raster call's fixed
cost live?

The port of ``benches/micro_fixed.py`` (its Pallas ``variant_kernel``
:36, pallas_call :93) as kernel M1 over the same 736x1280 frame: 460 tiles
of 16x128, two a grid step (230 steps), colour SKY and depth +inf.

- level 0: the constant frame only;
- level 1: + each tile's starts and counts read, and its first record
  block (24 x 256 int32) staged in VMEM when its count is positive (the
  TPU started that copy and never waited on it).  No value depends on
  it, so it has no counterpart: level 1 launches level 0's form;
- level 2: the original adds an empty ``fori_loop`` over the tile's
  blocks that carries its state unchanged; it has no counterpart either.

Operands, the original's: starts, counts [460], rows [12288] int32 and
zmin [12288] float32 (its scalar-prefetch arrays) and the records [24,
98304] (its ANY input), all passed to the launch.  Its VMEM scratch,
(24, 2*2*256) and (256, 24) int32, and its DMA semaphores have no
counterpart: nothing reads them, and the kernel reserves no shared
memory.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.micro_fixed [levels]
"""

from __future__ import annotations

import sys

import numpy as np

from ..ops import micro
from . import common as C

LEVELS = (0, 1, 2)
SITE = "benches/micro_fixed.py:93"


def build_inputs(seed=None) -> dict:
    """The original's operands as numpy arrays: zeros (zmin +inf) as its
    ``main`` makes them, or, with a ``seed``, random tile counts whose
    segments tile the record stream, so that level 1 stages records."""
    counts = np.zeros(C.N_TILES, np.int32)
    if seed is not None:
        counts = np.random.default_rng(seed).integers(
            0, 200, C.N_TILES).astype(np.int32)
    return {"starts": (np.cumsum(counts) - counts).astype(np.int32),
            "counts": counts, "rows": np.zeros(C.N_OCT, np.int32),
            "zmin": np.full(C.N_OCT, np.inf, np.float32),
            "recs": np.zeros((24, C.TK), np.int32)}


def variant(level) -> C.Variant:
    level = int(level)
    if level not in LEVELS:
        raise KeyError(f"no micro_fixed level {level}")
    lay = C.frame_layout(flags=micro.DEPTH)

    def run(t, plain):
        fn = micro.fill_tiles_plain if plain else micro.fill_tiles
        return fn(lay, starts=t["starts"], counts=t["counts"],
                  meta_rows=t["rows"], meta_zmin=t["zmin"], recs=t["recs"])

    note = ("the record stage decided no value and has no counterpart: "
            "level 0's form with the same operands" if level else "")
    if level == 2:
        note += "; so has the empty fori_loop over the tile's blocks"
    return C.Variant("M1", SITE, lambda inputs: inputs, run,
                     C.fill_bytes(lay, has_x=False), layout=lay, note=note)


def prepare(level, inputs=None, device="cuda", plain: bool = False):
    """The level's call on ``device`` (the card unless ``device="cpu"``)
    with ``inputs`` (``build_inputs()`` by default) made there: a function
    of no arguments that returns (colour, depth).  ``plain`` runs the
    plain PyTorch version instead of the kernel."""
    v = variant(level)
    t = C.tensors(v.arrays(build_inputs() if inputs is None else inputs),
                  device)
    return lambda: v.run(t, plain)


def run_variant(level, inputs=None, device="cuda", plain: bool = False):
    """The level's (colour, depth) (see ``prepare``)."""
    return prepare(level, inputs, device, plain)()


def time_variant(level, inputs=None) -> dict:
    """The level's times on the card (``common.measure``)."""
    return C.measure(prepare(level, inputs))


def main(argv=None) -> int:
    labels = sys.argv[1:] if argv is None else argv
    return C.main_loop(labels, LEVELS, time_variant, variant)


if __name__ == "__main__":
    sys.exit(main())
