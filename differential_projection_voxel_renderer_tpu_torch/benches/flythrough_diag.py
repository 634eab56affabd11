"""Which path each moving frame takes, and the host time of each call,
over the flythrough on the card.

The counterpart of ``benches/flythrough_diag.py``: the flythrough_bench's
engine and warm-ups, then its two passes of moving frames with the
renderer's entry points (``render_prepared``, ``render_fused``,
``render_fused_insert``, ``prepare_uploads`` and the resident append
steps), the pool's inserts and the engine's funnel, world update, meshing
and resident rebuild wrapped: each call is counted and its host time
summed.  No rendering path changes.  The kernels' launch counters
(``ops.geometry.launches``, ``ops.raster.launches``) are read a pass too.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.flythrough_diag [vd] [--frames N]

Prints, a pass, ``pass <p>: <fps> FPS (<ms> ms/frame)`` and one line a
wrapped call, ``  <name>: <calls>x, <ms> ms/frame (host-side call
time)``, then the pass's kernel launches.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..ops import geometry, raster
from .common import need_card
from .flythrough_bench import flight, warmed_engine

RENDERER_CALLS = ("render_prepared", "render_fused", "render_fused_insert",
                  "prepare_uploads", "render_prepared_append",
                  "render_prepared_append_insert")
POOL_CALLS = ("insert_many", "prepare_insert_payload",
              "dispatch_insert_payload")
ENGINE_CALLS = ("_funnel", "_mesh_list", "_mesh_list_resident",
                "_rebuild_resident", "_queue_append", "_remesh_list_of")


def wrap_calls(eng) -> tuple[dict, dict]:
    """Wrap the engine's paths with counters: ({name: calls}, {name: host
    ms}), filled as frames run."""
    counters, times = {}, {}

    def wrap(obj, name):
        fn = getattr(obj, name)

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            counters[name] = counters.get(name, 0) + 1
            times[name] = times.get(name, 0.0) + (
                time.perf_counter() - t0) * 1e3
            return out

        setattr(obj, name, wrapped)

    for name in RENDERER_CALLS:
        wrap(eng.renderer, name)
    for name in POOL_CALLS:
        wrap(eng.pool, name)
    for name in ENGINE_CALLS:
        wrap(eng, name)
    wrap(eng.world, "update")
    return counters, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("vd", nargs="?", type=int, default=12)
    ap.add_argument("--frames", type=int, default=40)
    a = ap.parse_args(argv)
    need_card()
    eng = warmed_engine(a.vd, pipelined=False)
    counters, times = wrap_calls(eng)
    n = a.frames
    for pas in range(2):
        counters.clear()
        times.clear()
        k1, k2 = geometry.launches, raster.launches
        dt, _ = flight(eng, n, pipelined=False)
        print(f"pass {pas}: {n / dt:.1f} FPS ({dt / n * 1e3:.2f} ms/frame)")
        for k in sorted(counters):
            print(f"  {k}: {counters[k]}x, {times[k] / n:.3f} ms/frame "
                  f"(host-side call time)")
        print(f"  launches: K1 {geometry.launches - k1}, K2 "
              f"{raster.launches - k2}")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
