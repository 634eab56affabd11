"""K1 (stage A) and its call on the card, in one tree or in turns across
two trees.

    python differential_projection_voxel_renderer_tpu_torch/benches/k1_call.py [--tree DIR]
    python differential_projection_voxel_renderer_tpu_torch/benches/k1_call.py --turns DIR_A DIR_B
    python differential_projection_voxel_renderer_tpu_torch/benches/k1_call.py --variants

With ``--tree`` (by default the tree this file lies in) it imports the
port package found in DIR, builds its kernels and prints one JSON line:
K1 on a fuzzed stream at 131072 quads (n 120000) and at 49152 (n 45827,
the bucket and length of the 1280x720 vd12 start pose) under the start
pose's camera -- device ms a call from a CUDA graph (30 calls, median of
10 replays), ms a call (median of 20), ms in runs of 20 (median of 20
runs), and the same for stage A as the step takes it (K1 and, where K1
sums no counts, the step's two sums of its outputs) -- the host us of a
wrapper call at 131072 (median of 7 blocks of 50 queued calls), and the
host calls that launch work (``cudaLaunchKernel``, ``cudaMemsetAsync``)
in one ``render_step`` on the 128x128 fuzz scene, counted by
torch.profiler.  It calls only the public entry points
(``ops.geometry.project_cull``, ``rendering.pipeline.render_step``), so
it reads any tree of the port.

With ``--turns`` it runs DIR_A, DIR_B, DIR_B, DIR_A, each in a process of
its own, and prints their lines and the card's name and power limit
(nvidia-smi).

With ``--variants`` it times K1 of this tree at one, two and four
consecutive quads a thread (``ops.geometry.QUADS_PER_THREAD``) in turns
(1, 2, 4, 4, 2, 1), at both sizes, a call, in runs and from a graph, and
prints one JSON line a turn and the card's line.  Needs a CUDA card;
imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WIDTH, HEIGHT = 1280, 720
START_POS, START_TARGET = (0.0, 10.0, 20.0), (0.0, 0.0, -60.0)
SIZES = ((131072, 120000), (49152, 45827))
TURNS = 7


def fuzz_stream(torch, n, seed=0):
    """Random valid quad words over all faces and field ranges, chunk
    origins within 12 chunks (chip_smoke.py's fuzzed stream too)."""
    g = torch.Generator().manual_seed(seed)
    u, v, w, h, blk, sl, face = (torch.randint(0, hi, (n,), generator=g)
                                 for hi in (32, 32, 64, 64, 4, 32, 6))
    words = (u | (v << 5) | (w << 10) | (h << 16) | (blk << 22)
             | (sl << 24) | (face << 29))
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    qw = (torch.randint(-12, 13, (3, n), generator=g) * 32).float()
    qw[1] = (torch.randint(-2, 2, (n,), generator=g) * 32).float()
    return words.cuda(), qw.cuda()


def launch_calls(torch, parity, pipeline) -> dict:
    """Host launch calls of one render_step on the 128x128 fuzz scene."""
    from torch.profiler import ProfilerActivity, profile

    args, kw = parity.small_scene("fuzz 128x128", "cuda")
    pipeline.render_step(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipeline.render_step(*args, **kw)
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()}
    return {k: calls.get(k, 0) for k in ("cudaLaunchKernel",
                                         "cudaMemsetAsync")}


def _modules(tree: str):
    """This tree's torch and port modules (its kernels built) and the
    start pose's camera as (view_proj, cam_pos), views of one f32[19]."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("k1_call needs a CUDA card")
    sys.path.insert(0, tree)
    from differential_projection_voxel_renderer_tpu_torch import _build
    from differential_projection_voxel_renderer_tpu_torch.benches import (
        common,
    )
    from differential_projection_voxel_renderer_tpu_torch.models.camera import (
        Camera,
    )
    from differential_projection_voxel_renderer_tpu_torch.ops import geometry
    from differential_projection_voxel_renderer_tpu_torch.rendering import (
        parity,
        pipeline,
    )

    import numpy as np

    if not os.path.abspath(_build.__file__).startswith(
            os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {_build.__file__}, not from {tree}")
    _build.build()
    cam = Camera(np.asarray(START_POS, np.float32), WIDTH / HEIGHT)
    cam.look_at(np.asarray(START_TARGET, np.float32))
    cam_f = torch.from_numpy(np.concatenate([
        cam.view_projection_matrix().ravel(), cam.position]).astype(
            np.float32)).cuda()
    return (torch, common, geometry, parity, pipeline,
            cam_f[:16].reshape(4, 4), cam_f[16:19])


def _sized_args(torch, vp, cp) -> list:
    """[(gq, n, K1's positional arguments)] at SIZES, on one stream."""
    words, qw = fuzz_stream(torch, SIZES[0][0])
    return [(gq, n, (words[:gq], qw[:, :gq].contiguous(),
                     torch.tensor(n, dtype=torch.int32, device="cuda"), vp,
                     cp)) for gq, n in SIZES]


def one_tree(tree: str) -> dict:
    torch, common, geometry, parity, pipeline, vp, cp = _modules(tree)
    kw = dict(width=WIDTH, height=HEIGHT)
    res = dict(tree=tree, sizes={})
    for gq, n, args in _sized_args(torch, vp, cp):
        def wrapper(args=args):
            return geometry.project_cull(*args, **kw)

        def stage(args=args):
            out = geometry.project_cull(*args, **kw)
            if "valid_count" not in out:
                return (out["subpixel"].sum(dtype=torch.int32),
                        out["valid"].sum(dtype=torch.int32))
            return out

        res["sizes"][gq] = dict(
            n=n, graph_ms=common.graph_ms(wrapper),
            call_ms=common.median_ms(wrapper),
            run_ms=common.median_ms(wrapper, batch=20),
            stage_graph_ms=common.graph_ms(stage),
            stage_run_ms=common.median_ms(stage, batch=20))
        if gq == SIZES[0][0]:
            res["wrapper_us"] = statistics.median(
                common.host_us(wrapper, blocks=1) for _ in range(TURNS))
    res["step_launch_calls"] = launch_calls(torch, parity, pipeline)
    return res


def variants(tree: str) -> None:
    torch, common, geometry, _, _, vp, cp = _modules(tree)
    kw = dict(width=WIDTH, height=HEIGHT)
    sized = _sized_args(torch, vp, cp)
    for qpt in (1, 2, 4, 4, 2, 1):
        geometry.QUADS_PER_THREAD = qpt
        res = dict(quads_per_thread=qpt, sizes={})
        for gq, n, args in sized:
            def wrapper(args=args):
                return geometry.project_cull(*args, **kw)

            res["sizes"][gq] = dict(
                n=n, graph_ms=common.graph_ms(wrapper),
                call_ms=common.median_ms(wrapper),
                run_ms=common.median_ms(wrapper, batch=20))
        print(json.dumps(res), flush=True)
    geometry.QUADS_PER_THREAD = 1


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--turns", nargs=2, metavar=("DIR_A", "DIR_B"))
    ap.add_argument("--variants", action="store_true")
    a = ap.parse_args()
    if a.variants:
        variants(os.path.abspath(a.tree))
        print(smi_line(), flush=True)
        return 0
    if not a.turns:
        print(json.dumps(one_tree(os.path.abspath(a.tree))), flush=True)
        return 0
    a_dir, b_dir = (os.path.abspath(d) for d in a.turns)
    for d in (a_dir, b_dir, b_dir, a_dir):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", d], capture_output=True, text=True,
                             timeout=900)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    print(smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
