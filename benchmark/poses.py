"""The one pose generator: a traffic mix (``traffic/<mix>.json``) is its
parameters.  A pose is a function of the seed and the frame index, never
of the clock, so a faster program covers the same path further at the
same work a frame.

The motion is that of the port's ``benches/flythrough_bench.py`` at
commit 1521963 (frozen here): ``move`` world units and ``yaw_step``
radians a frame, ``dt`` 0.016 s handed to the entry point.  Parameters:

- ``start`` [x, y, z] and ``pitch`` (radians);
- ``yaw``: the start yaw, or ``"seed"`` for one drawn uniformly from
  [0, 2 pi) by the seed;
- ``move`` and ``yaw_step``: added each frame;
- ``keys`` (optional): a list of [x, y, z, yaw, pitch] poses that stand in
  for ``start``, ``yaw`` and ``pitch``, the camera jumping to the next
  every ``frames_per_key`` frames and cycling the list; the seed draws
  the key it starts at;
- ``jitter`` (optional): {"position", "yaw", "pitch"}, the half-widths of
  uniform offsets added to each frame's pose, drawn by the seed from a
  table of ``JITTER_TABLE`` entries indexed by the frame;
- ``loop`` (``"closed"``) and ``outstanding``: frames issued before the
  loop waits for the oldest;
- ``warmup_frames``: frames rendered in set-up, before the window; the
  window goes on from there.

Every seed sees the same kind of poses (the same keys, the same widths of
jitter), in another order or from another start."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# flythrough_bench.py's motion, frozen
FLY_STEP = (0.4, 0.0, -0.4)
FLY_YAW_STEP = 0.01
FLY_DT = 0.016
JITTER_TABLE = 4096
KNOWN = {"name", "why", "start", "pitch", "yaw", "move", "yaw_step", "dt",
         "keys", "frames_per_key", "jitter", "loop", "outstanding",
         "warmup_frames"}


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of ``seed``'s draws for purpose ``stream``: any whole
    number is a seed."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


@dataclass(frozen=True)
class Pose:
    position: tuple[float, float, float]
    yaw: float
    pitch: float


class Traffic:
    def __init__(self, params: dict, seed: int):
        unknown = set(params) - KNOWN
        if unknown:
            raise ValueError(f"unknown traffic parameters {sorted(unknown)}")
        if params.get("loop", "closed") != "closed":
            raise ValueError("only the closed loop is generated")
        self.params = params
        self.name = params.get("name", "")
        r = rng(seed, 1)
        keys = params.get("keys")
        if keys:
            self.keys = np.asarray(keys, np.float64).reshape(-1, 5)
            self.per_key = int(params.get("frames_per_key", 1))
            self.key0 = int(r.integers(0, len(self.keys)))
        else:
            self.keys = None
            self.start = np.asarray(params["start"], np.float64)
            yaw = params.get("yaw", 0.0)
            self.yaw0 = (float(r.uniform(0.0, 2 * math.pi)) if yaw == "seed"
                         else float(yaw))
            self.pitch = float(params["pitch"])
        self.move = np.asarray(params.get("move", (0.0, 0.0, 0.0)),
                               np.float64)
        self.yaw_step = float(params.get("yaw_step", 0.0))
        self.dt = float(params.get("dt", FLY_DT))
        self.outstanding = int(params.get("outstanding", 2))
        self.warmup = int(params.get("warmup_frames", 64))
        j = params.get("jitter")
        self.jitter = None
        if j:
            u = rng(seed, 4).uniform(-1.0, 1.0, size=(JITTER_TABLE, 5))
            width = np.array([j.get("position", 0.0)] * 3
                             + [j.get("yaw", 0.0), j.get("pitch", 0.0)])
            self.jitter = u * width

    @property
    def moves(self) -> bool:
        """Whether the camera's position changes from frame to frame."""
        return bool(self.move.any() or (self.keys is not None
                                        and len(self.keys) > 1)
                    or (self.jitter is not None and self.jitter[:, :3].any()))

    def pose(self, i: int) -> Pose:
        if self.keys is not None:
            k = self.keys[(self.key0 + i // self.per_key) % len(self.keys)]
            p, yaw, pitch = k[:3] + i * self.move, k[3], k[4]
        else:
            p, yaw, pitch = self.start + i * self.move, self.yaw0, self.pitch
        yaw = yaw + i * self.yaw_step
        if self.jitter is not None:
            d = self.jitter[i % JITTER_TABLE]
            p, yaw, pitch = p + d[:3], yaw + d[3], pitch + d[4]
        return Pose((float(p[0]), float(p[1]), float(p[2])), float(yaw),
                    float(pitch))
