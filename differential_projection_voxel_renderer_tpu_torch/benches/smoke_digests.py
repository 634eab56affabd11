"""Digests of ``chip_smoke.py``'s serial and packed frames, to compare trees.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.smoke_digests

Phase 3 of ``chip_smoke.py`` renders a serial engine over its camera
sequence (static frames at the start pose, then the moving poses that
stream chunks), and phase 10 renders the same sequence on a packed engine
(``RenderConfig(packed_raster=True)``), each frame held to phase 3's bit
for bit within the run.  This renders that sequence on both engines, made,
settled and primed by ``chip_smoke.new_engine``: 3 + ``N_TIMED_PIPELINED``
static frames (phase 10's count), then ``chip_smoke.moving_poses``.  It
prints one JSON line -- each engine's digest of its first static frame and
of each moving frame (``digest``), whether its static frames were all
equal, each frame's ``bin_overflow`` (stats[3]) and the frames whose
digests differ between the engines -- and the card's name and
power limit (nvidia-smi).  Run from the root of a checkout (it imports that
checkout's ``chip_smoke``), it digests that tree's frames, so that two
trees compare on one card by their lines.  Needs a CUDA card; about 30 s
of an H100 with the kernels' build.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import torch

from ..app.engine import RenderConfig


def digest(frame) -> str:
    """The first 12 hex digits of the SHA-1 of a frame's colour and depth
    bytes, to compare frames across processes and trees."""
    h = hashlib.sha1(frame[0].cpu().numpy().tobytes())
    h.update(frame[1].cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def fly(smoke, config):
    """(colour, depth, stats) of the first static frame and of each moving
    frame of the smoke run's sequence on a new engine, and whether every
    static frame equalled the first."""
    eng = smoke.new_engine(torch, config)[0]

    def frame():
        r = eng.render_frame(dt=0.0)
        return r.color.clone(), r.depth.clone(), r.stats.clone()

    first = frame()
    same = all(all(torch.equal(a, b) for a, b in zip(frame(), first))
               for _ in range(2 + smoke.N_TIMED_PIPELINED))
    frames = [first]
    for pos, target in smoke.moving_poses():
        eng.camera.position = pos
        eng.camera.look_at(target)
        frames.append(frame())
    return frames, same


def main() -> int:
    if not torch.cuda.is_available():
        print("smoke_digests: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    size = (smoke.WIDTH, smoke.HEIGHT)
    flights = {kind: fly(smoke, RenderConfig(*size, packed_raster=packed))
               for kind, packed in (("serial", False), ("packed", True))}
    digests = {k: [digest(f) for f in v[0]] for k, v in flights.items()}
    print(json.dumps(dict(
        digests=digests,
        static_frames_equal={k: v[1] for k, v in flights.items()},
        bin_overflow={k: [int(f[2][3]) for f in v[0]]
                      for k, v in flights.items()},
        packed_differs=[i for i, (a, b) in enumerate(zip(
            digests["serial"], digests["packed"])) if a != b])), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
