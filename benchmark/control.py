"""The control and the planted faults of a cell, at the cell's own size:
the readings that the limits in ``cells/<workload>.json`` are set from.

    python3 benchmark/control.py --workload vd12_720p.pan \\
        --seeds 11 12 13 --seconds 2 [--faults altered_pixels ...]

For each seed: the cell's set-up, a window of ``--seconds``, and the
comparison of its sampled frames (the sound reading); the control, the
reference computed in bfloat16 in the program's place over the same
frames; then each fault alone, planted in the same engine, a window of
``--seconds`` judged again, and the fault taken out.  One JSON line a seed on standard output.
Not part of a benchmark run."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import correct, faults as faults_mod, spec  # noqa: E402
from benchmark.harness import build, runner_module  # noqa: E402


def readings(cell, seed: int, seconds: float, fault_names, device="cuda"):
    import torch

    mod = runner_module(cell)
    judge = getattr(mod, "judge", correct.judge)
    control = getattr(mod, "control", correct.control)
    runner = build(cell, seed, device)
    runner.setup()
    runner.window(seconds, False)
    samples = runner.host_samples()
    out = {"seed": seed}
    out["sound"] = judge(cell.config, samples, seed, cell.limits,
                         device)[1]
    out["control"] = control(cell.config, samples, seed, cell.limits,
                             device)
    for name in fault_names:
        undo = faults_mod.FAULTS[name](runner)
        runner.samples = []
        runner.window(seconds, False)
        fs = runner.host_samples()
        undo()
        out[name] = judge(cell.config, fs, seed, cell.limits, device)[1]
    runner.release()
    if torch.device(device).type != "cpu":
        torch.cuda.empty_cache()
    out["sound"] = {k: v for k, (v, _) in out["sound"].items()}
    for name in fault_names:
        out[name] = {k: v for k, (v, _) in out[name].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", nargs="*", default=None,
                    help="by default every fault the cell can have")
    a = ap.parse_args(argv)
    cell = spec.cell(a.workload)
    if a.faults is None:
        a.faults = list(faults_mod.FAULTS)
    for seed in a.seeds:
        t = time.perf_counter()
        r = readings(cell, seed, a.seconds, a.faults)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
