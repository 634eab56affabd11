"""The control and the planted faults of a views cell, at the cell's own
size: ``control.py``'s readings with the views runner's faults of the
exchange (``runners/views.py FAULTS``) beside ``faults.py``'s.

    python3 benchmark/control_views.py --workload vd12_720p_2x2.views \\
        --seeds 11 12 13 --seconds 2 [--faults no_exchange ...]

One JSON line a seed on standard output, as ``control.py`` prints them.
Not part of a benchmark run."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import control, faults, spec  # noqa: E402

# the faults that reach an engine driven through render_views
DEFAULT = ("no_exchange", "altered_band", "half_drawlist", "altered_mesh")


def with_views_faults(cell) -> None:
    """Make the cell's runner's faults known to ``control.readings``."""
    mod = spec.runner(cell.config["runner"])
    faults.FAULTS.update(getattr(mod, "FAULTS", {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", nargs="*", default=list(DEFAULT))
    a = ap.parse_args(argv)
    cell = spec.cell(a.workload)
    with_views_faults(cell)
    for seed in a.seeds:
        t = time.perf_counter()
        r = control.readings(cell, seed, a.seconds, a.faults)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
