"""The binning's big-quad cap on the 1280x720 view-distance-12 flythrough.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.big_quad_cap [CAP ...]

``ops.raster.build_tile_lists`` bins at most ``ops.raster.BIG_CAP`` quads
that cover more than 2x2 tiles (and at most 64), the first by stream
index; the rest are dropped and counted in the frame's ``bin_overflow``
(stats[3]).  For each cap (by default 512, the reference's, 1024 and
2048, the port's) this flies ``app/flythrough.default_path(24)`` on a
serial and a resident engine (``Engine(resident_stream=True)``), each
primed with ``prime_all`` at the reference start pose (16384 pool slots),
and prints one JSON line a cap: each engine's ``bin_overflow`` a frame
(the resident stream's also counts the near-plane boxes past
``ops.raster.HUGE_CAP``), the frames where the two engines differ, and
the pixels a frame that differ from the same engine's frames at the
largest cap given.  Ends with the card's name and power limit
(nvidia-smi).  Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ..app import flythrough
from ..app.engine import Engine, RenderConfig, WorldConfig
from ..ops import raster

START_POS, START_TARGET = (0.0, 10.0, 20.0), (0.0, 0.0, -60.0)
CAPS = (512, 1024, 2048)
KEYS = 24


def fly(resident: bool) -> list:
    """(colour, depth, stats) of each key of the flight, on the card."""
    eng = Engine(RenderConfig(1280, 720), WorldConfig(view_distance=12),
                 pool_slots=16384, resident_stream=resident)
    eng.camera.position = np.array(START_POS, np.float32)
    eng.camera.look_at(np.array(START_TARGET, np.float32))
    while eng.world.update(eng.camera.position):
        pass
    eng.prime_all()
    eng.render_frame(dt=0.0)
    frames = [(r.color.clone(), r.depth.clone(), r.stats.clone())
              for r in flythrough.run_flythrough(
                  eng, flythrough.default_path(KEYS))]
    if resident and not eng.resident_stream:
        raise RuntimeError("the resident engine left resident mode")
    return frames


def differ(a, b) -> int:
    """Pixels where two frames differ in colour or depth bits."""
    return int(((a[0] != b[0])
                | (a[1].view(torch.int32) != b[1].view(torch.int32))).sum())


def main(argv=None) -> int:
    caps = [int(c) for c in (argv if argv is not None else sys.argv[1:])]
    caps = caps or list(CAPS)
    if not torch.cuda.is_available():
        print("big_quad_cap: no CUDA device", file=sys.stderr)
        return 1
    flights = {}
    for cap in caps:
        raster.BIG_CAP = cap
        flights[cap] = {kind: fly(kind == "resident")
                        for kind in ("serial", "resident")}
    ref = flights[max(caps)]
    for cap, f in flights.items():
        print(json.dumps(dict(
            big_cap=cap, huge_cap=raster.HUGE_CAP,
            bin_overflow={k: [int(x[2][3]) for x in v] for k, v in f.items()},
            resident_vs_serial=[i for i, (a, b) in enumerate(
                zip(f["serial"], f["resident"])) if differ(a, b)],
            pixels_vs_largest_cap={k: [differ(a, b) for a, b in zip(
                v, ref[k])] for k, v in f.items()})), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
