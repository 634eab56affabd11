"""How ``correct`` is decided: each sampled frame of the window (frames
drawn from the seed, and the last one) against the reference's frame of
the same pose over the same loaded chunks.

Numbers compared, each the worst over the sampled frames:

- ``mesh_diff``: chunks of the reference's draw list whose mesh the
  program does not hold, or holds otherwise (its words or its counts by
  face direction) than the reference meshes it;
- ``gathered_diff``: |stats[0] - the reference's expanded stream length|,
  which the draw list and its face-direction masks set;
- ``dropped``: stats[2] + stats[3], quads the caps dropped;
- ``rasterized_diff``: |stats[1] - the quads that pass the reference's
  stage A|;
- ``pixel_mismatch``: the share of the sampled rows' pixels that differ
  from the reference's: in colour, in being covered at all, or in depth
  by more than DEPTH_TOL (float32 rounding of NDC depth is under 1e-5;
  two quads of one colour meeting at an edge that the rounding gives to
  the other differ by far more, which is why depth is not compared as a
  largest gap).

The limits are in ``cells/<workload>.json``; a number passes at or under
its limit."""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import poses
from .reference.frame import Reference

DEPTH_TOL = 1e-4


def pixels_differ(color, depth, ref) -> np.ndarray:
    """bool [R, W]: the sampled rows' pixels that differ from the
    reference frame ``ref``."""
    fin, rfin = np.isfinite(depth), np.isfinite(ref.depth)
    both = fin & rfin
    near = np.abs(np.where(both, depth, 0.0)
                  - np.where(both, ref.depth, 0.0)) <= DEPTH_TOL
    return (color != ref.color) | (fin != rfin) | ~near


def rows_of(seed: int, sample: dict, step: int) -> int:
    """The first sampled row of a frame, drawn from the seed."""
    return int(poses.rng(seed, 3 + int(sample["k"])).integers(0, step))


def program_mesh(sample: dict):
    """``p -> the program's mesh words of chunk p, or None``."""
    meshes = sample["meshes"]

    def get(p):
        got = meshes.get(tuple(int(c) for c in p))
        return None if got is None else got[0]

    return get


def ref_frame(ref: Reference, sample: dict, first: int, step: int):
    return ref.frame(sample["keys"], sample["pose"], first, step,
                     pooled=sample["pooled"], program=program_mesh(sample))


def compare(sample: dict, ref, rows_first: int, rows_step: int) -> dict:
    """The numbers of one frame: ``sample`` the program's (host arrays),
    ``ref`` the reference's RefFrame."""
    mesh_diff = 0
    for p, m in zip(ref.positions.tolist(), ref.meshes):
        got = sample["meshes"].get(tuple(p))
        faces = np.bincount((m >> 29) & 7, minlength=6)[:6]
        if got is None or len(got[0]) != len(m) or (got[0] != m).any() or (
                faces != got[1]).any():
            mesh_diff += 1
    st = np.asarray(sample["stats"]).astype(np.int64)
    differ = pixels_differ(
        sample["color"][rows_first::rows_step],
        sample["depth"][rows_first::rows_step].astype(np.float64), ref)
    return dict(mesh_diff=mesh_diff,
                gathered_diff=abs(int(st[0]) - ref.gathered),
                dropped=int(st[2] + st[3]),
                rasterized_diff=abs(int(st[1]) - ref.rasterized),
                pixel_mismatch=float(differ.mean()))


def worst(per_frame: list) -> dict:
    return {k: max(f[k] for f in per_frame) for k in per_frame[0]}


def judge(config: dict, samples: list, seed: int, limits: dict, device,
          dtype=torch.float64) -> tuple[bool, dict]:
    """(correct, {number: (value, limit)}) over the sampled frames, the
    numbers those that the cell's limits name."""
    ref = Reference(config, device, dtype)
    step = int(limits["sample"]["row_step"])
    per = []
    for s in samples:
        first = rows_of(seed, s, step)
        per.append(compare(s, ref_frame(ref, s, first, step), first, step))
        _log(s["k"], np.asarray(s["stats"]).tolist(), per[-1])
    got = worst(per)
    lim = limits["limits"]
    table = {k: (got[k], lim[k]) for k in lim}
    return all(v <= m for v, m in table.values()), table


def _log(k: int, stats: list, nums: dict) -> None:
    print(f"sampled frame {k}: stats {stats} {nums}", file=sys.stderr,
          flush=True)


def control(config: dict, samples: list, seed: int, limits: dict, device,
            dtype=torch.bfloat16) -> dict:
    """The control's numbers: the reference computed in ``dtype`` put in
    the program's place (its frame, stream and stage-A count) and held to
    the reference in float64 over the same poses, chunks and rows."""
    hi = Reference(config, device, torch.float64)
    lo = Reference(config, device, dtype)
    step = int(limits["sample"]["row_step"])
    per = []
    for s in samples:
        first = rows_of(seed, s, step)
        want, got = ref_frame(hi, s, first, step), ref_frame(lo, s, first,
                                                             step)
        color = np.zeros((hi.height, hi.width), np.int32)
        depth = np.zeros((hi.height, hi.width), np.float64)
        color[first::step], depth[first::step] = got.color, got.depth
        meshes = {tuple(p): (m, np.bincount((m >> 29) & 7,
                                            minlength=6)[:6])
                  for p, m in zip(got.positions.tolist(), got.meshes)}
        fake = dict(meshes=meshes, color=color, depth=depth,
                    stats=np.array([got.gathered, got.rasterized, 0, 0]))
        per.append(compare(fake, want, first, step))
    return worst(per)
