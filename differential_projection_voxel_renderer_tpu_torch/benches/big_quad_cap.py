"""The binnings' big-quad caps on the 1280x720 view-distance-12 flythrough.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.big_quad_cap [--keys N] [--huge-cap H ...] [CAP ...]

Both binnings, ``ops.raster.build_tile_lists`` (the default raster) and
``ops.raster_packed.build_bin_lists`` (``RenderConfig.packed_raster``),
bin the first ``ops.raster.BIG_CAP`` quads by stream index of those over
more than 2x2 tiles and at most 64, and the first ``ops.raster.HUGE_CAP``
of those over more than 64; the rest are dropped and counted in the
frame's ``bin_overflow`` (stats[3]).  For each cap (by default 512, the
reference's, 1024 and 2048, the port's) and each huge cap
(``--huge-cap``, by default 64, the reference's and the port's), this flies ``app/flythrough.default_path(N)``
(``--keys``, default 24; 96 flies the same orbit at four times the keys,
so several frames fall in each chunk cell) on three engines, each primed
with ``prime_all`` at the reference start pose (16384 pool slots): a
serial one, a resident one (``Engine(resident_stream=True)``, whose stream
also holds the chunks behind the camera) and a packed one
(``RenderConfig(packed_raster=True)``).  At a huge cap above 64 every
engine's item cap is raised past the renderer's own bound to the resident
one's (131072) plus a whole grid of items for each huge quad, so that a
huge quad kept is never an item dropped.

One JSON line a (cap, huge cap): the caps, each engine's item cap, the
packed binning's sort length (keys a frame at the step's shapes,
``raster_packed.sort_length``) and the reference's at its one class of
512; each engine's ``bin_overflow`` a key, and what its binning saw a key
(``binned``: its big, huge and whole-grid quads, and the overflow split
into big quads dropped, huge quads dropped and items past the item cap);
for the resident and packed engines the keys whose frame differs from the
serial frame of the same key and the pixels that differ a key (colour or
depth bits); each frame's digest (the first 12 hex digits of the SHA-1 of
its colour and depth, to compare runs); and the pixels a key that differ
from the same engine's frames at the largest caps given.  Ends with the
card's name and power limit (nvidia-smi).  Needs a CUDA card; the default
run takes about 20 s of an H100, ``--keys 96 2048 --huge-cap 64 1024``
about 26 s.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..app import flythrough
from ..app.engine import Engine, RenderConfig, WorldConfig
from ..ops import raster, raster_packed
from .smoke_digests import digest

START_POS, START_TARGET = (0.0, 10.0, 20.0), (0.0, 0.0, -60.0)
CAPS = (512, 1024, 2048)
KEYS = 24
ENGINES = ("serial", "resident", "packed")
# the resident mode's item cap (app/engine.py) and the frame's tiles
RESIDENT_ITEMS, TILES = 131072, (720 // 16) * (1280 // 128)


class BinSpy:
    """Wraps both binnings and their shared big-quad expansion
    (``raster.big_quad_tiles``) while installed: each binning call records
    the big, huge and whole-grid quads the expansion was given and the
    frame's overflow split into big quads dropped, huge quads dropped and
    items past the item cap (one host sync a call)."""

    def __init__(self):
        self.calls = []
        self.saved = (raster.build_tile_lists, raster_packed.build_bin_lists,
                      raster.big_quad_tiles)
        self.classes = None

    def _expand(self, classes, tx0, ty0, spanx, ntile):
        out = self.saved[2](classes, tx0, ty0, spanx, ntile)
        whole = sum((mask & (ntile == TILES)).sum() for mask, _, _ in classes)
        n = [int(x) for x in out[-1].tolist()] + [0]
        caps = [cap for _, cap, _ in classes] + [0]
        self.classes = dict(big=n[0], huge=n[1], whole=int(whole),
                            dropped=[max(n[i] - caps[i], 0) for i in (0, 1)])
        return out

    def _wrap(self, fn):
        def spy(*a, **kw):
            out = fn(*a, **kw)
            rec = self.classes
            rec["dropped"].append(int(out[-1]) - sum(rec["dropped"]))
            self.calls.append(rec)
            return out
        return spy

    def __enter__(self):
        raster.build_tile_lists = self._wrap(self.saved[0])
        raster_packed.build_bin_lists = self._wrap(self.saved[1])
        raster.big_quad_tiles = self._expand
        return self

    def __exit__(self, *exc):
        (raster.build_tile_lists, raster_packed.build_bin_lists,
         raster.big_quad_tiles) = self.saved


def fly(kind: str, keys: int, item_cap: int | None):
    """(colour, depth, stats) of each key of the flight on the card, the
    binning's record of each key (BinSpy) and the item cap."""
    eng = Engine(RenderConfig(1280, 720, packed_raster=kind == "packed"),
                 WorldConfig(view_distance=12), pool_slots=16384,
                 resident_stream=kind == "resident")
    if item_cap:  # past the renderer's own bound, twice the gather bucket
        bucket_kw = eng.renderer._bucket_kw
        eng.renderer._bucket_kw = lambda cap: dict(bucket_kw(cap),
                                                   tile_k_cap=item_cap)
    eng.camera.position = np.array(START_POS, np.float32)
    eng.camera.look_at(np.array(START_TARGET, np.float32))
    while eng.world.update(eng.camera.position):
        pass
    eng.prime_all()
    eng.render_frame(dt=0.0)
    frames, bins = [], []
    for key in flythrough.default_path(keys):
        with BinSpy() as spy:
            r = flythrough.run_flythrough(eng, [key])[0]
        frames.append((r.color.clone(), r.depth.clone(), r.stats.clone()))
        bins.append(spy.calls)
    if kind == "resident" and not eng.resident_stream:
        raise RuntimeError("the resident engine left resident mode")
    return frames, bins, item_cap or eng.config.tile_k_cap


def reference_sort_length(m: int, item_cap: int) -> int:
    """``raster_packed.sort_length`` at the reference's binning: one class
    of 512 big quads over the whole grid."""
    saved = raster.BIG_CAP, raster.MAX_TILES_BIG
    raster.BIG_CAP, raster.MAX_TILES_BIG = 512, TILES
    try:
        return raster_packed.sort_length(m, TILES, item_cap)
    finally:
        raster.BIG_CAP, raster.MAX_TILES_BIG = saved


def differ(a, b) -> int:
    """Pixels where two frames differ in colour or depth bits."""
    return int(((a[0] != b[0])
                | (a[1].view(torch.int32) != b[1].view(torch.int32))).sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("caps", nargs="*", type=int, default=list(CAPS))
    ap.add_argument("--keys", type=int, default=KEYS)
    ap.add_argument("--huge-cap", type=int, nargs="+",
                    default=[raster.HUGE_CAP])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("big_quad_cap: no CUDA device", file=sys.stderr)
        return 1
    flights, huge0 = {}, raster.HUGE_CAP
    for huge in args.huge_cap:
        raster.HUGE_CAP = huge
        item_cap = None
        if huge > huge0:
            chap = raster_packed.CHAP_Q
            item_cap = -(-(RESIDENT_ITEMS + huge * TILES) // chap) * chap
        for cap in args.caps:
            raster.BIG_CAP = cap
            flights[cap, huge] = {kind: fly(kind, args.keys, item_cap)
                                  for kind in ENGINES}
    ref = flights[max(args.caps), max(args.huge_cap)]
    for (cap, huge), f in flights.items():
        raster.BIG_CAP, raster.HUGE_CAP = cap, huge
        frames = {k: v[0] for k, v in f.items()}
        vs_serial = {k: [differ(a, b) for a, b in zip(frames[k],
                                                      frames["serial"])]
                     for k in ENGINES[1:]}
        print(json.dumps(dict(
            keys=args.keys, big_cap=cap, huge_cap=huge,
            item_cap={k: v[2] for k, v in f.items()},
            packed_sort_length=raster_packed.sort_length(
                RenderConfig().quads_cap, TILES, f["packed"][2]),
            reference_sort_length=reference_sort_length(
                RenderConfig().quads_cap, f["packed"][2]),
            bin_overflow={k: [int(x[2][3]) for x in v]
                          for k, v in frames.items()},
            binned={k: v[1] for k, v in f.items()},
            keys_vs_serial={k: [i for i, n in enumerate(v) if n]
                            for k, v in vs_serial.items()},
            pixels_vs_serial=vs_serial,
            digests={k: [digest(x) for x in v] for k, v in frames.items()},
            pixels_vs_largest_caps={k: [differ(a, b) for a, b in zip(
                v, ref[k][0])] for k, v in frames.items()})), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
