"""One run of one cell: set-up, a measured window of ``--seconds``, the
comparison with the reference, and the result line.

``--trace 0`` reports the cell's end-to-end metrics (``fps``,
``frame_p99_ms``, ``setup_s``); ``--trace 1`` wraps the entry points in
spans, profiles a steady run of frames inside the window and reports the
cell's per-layer metrics, read by ``metrics/<name>.py``, with a
``breakdown``.  Both compare the sampled frames with the reference and
print each number beside its limit, as the last lines on standard error
and under ``compared``, the result line's last key."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "differential_projection_voxel_renderer_tpu")


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def device_info(devices, peak_bytes: int) -> dict:
    import torch

    d0 = devices[0]
    if d0.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(d0),
                "count": len(devices), "memory_peak_bytes": peak_bytes}
    return {"platform": "cpu", "kind": "cpu", "count": len(devices),
            "memory_peak_bytes": peak_bytes}


def peaks_of(kind: str) -> dict | None:
    from .spec import HERE

    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f).get(kind)


def runner_module(cell):
    from .spec import runner

    return runner(cell.config.get("runner", "engine"))


def build(cell, seed: int, device: str, trace: bool = False):
    return runner_module(cell).Runner(cell, seed, device=device,
                                      trace=trace)


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             *, device: str = "cuda") -> dict:
    """The result dict of one run (the last line's object)."""
    import torch

    from . import correct, timing
    from .trace import breakdown

    mod = runner_module(cell)
    runner = build(cell, seed, device, trace)
    devices = runner.devices
    runner.setup()
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.3f} s {runner.setup_info}")
    got = runner.window(seconds, trace)
    peak = (max(torch.cuda.max_memory_allocated(d) for d in devices)
            if devices[0].type == "cuda" else 0)
    frames = got["frames"]
    _log(f"window: {frames} frames in {got['window_s']:.6f} s; graph "
         f"captures in the window {got['captures_in_window']}; host "
         f"{runner.setup_info.get('window_host')}")
    samples = runner.host_samples()
    runner.release()
    del runner
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    judge = getattr(mod, "judge", correct.judge)
    ok, table = judge(cell.config, samples, seed, cell.limits, devices[0])
    _log(f"reference: {time.perf_counter() - t:.3f} s over "
         f"{len(samples)} frames")
    metrics = {}
    info = device_info(devices, peak)
    result = {"correct": ok, "attempted": frames, "failed": 0}
    if not trace:
        lat = got["latencies_ms"]
        values = {"fps": timing.rate(frames, got["window_s"]),
                  "frame_p99_ms": timing.percentile(lat, 99.0),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        _log(f"frame latency ms: median {timing.percentile(lat, 50):.4f}"
             f", p99 {values['frame_p99_ms']:.4f}, max {max(lat):.4f}")
    else:
        from .spec import metric_reader

        prof = got["profile"]
        ctx = dict(profile=prof, spans=got["spans"],
                   peaks=peaks_of(info["kind"]))
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy = prof.get("busy_us", {})
        info["busy_s"] = (sum(busy.values()) / len(devices) / 1e6
                          if busy else 0.0)
        info["window_s"] = prof.get("window_us", 0.0) / 1e6
        result["breakdown"] = breakdown(prof)
    result["metrics"] = metrics
    result["device"] = info
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in table.items()}
    for k, (v, lim) in table.items():
        _log(f"compared {k}: {v!r} limit {lim!r}")
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    from . import spec

    cell = spec.cell(a.workload)
    import torch

    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        _log(f"{a.workload} needs {cell.chips} CUDA card(s); "
             f"cuda available {torch.cuda.is_available()}, "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             f" present")
        return 2
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace), t_start)
    bad = forbidden_modules()
    if bad:
        _log(f"loaded in this process: {', '.join(bad)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0
