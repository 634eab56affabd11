"""Everything the harness runs is found by name: ``BENCHMARK.json`` at the
root of the checkout names the cells; a cell's configuration is
``configs/<config>.json``, which names its runner ``runners/<runner>.py``;
its traffic is ``traffic/<traffic>.json``, its comparison's sample and
limits and its traced window ``cells/<workload>.json``, and each
per-layer metric ``metrics/<name>.py``.  Adding one adds files; no file
here lists them."""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(folder: str, name: str, ext: str) -> str:
    if not name or "/" in name or name.startswith("."):
        raise ValueError(f"not a name: {name!r}")
    return os.path.join(HERE, folder, name + ext)


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def benchmark_json(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def config(name: str) -> dict:
    return dict(_json(_named("configs", name, ".json")), name=name)


def traffic(name: str) -> dict:
    return dict(_json(_named("traffic", name, ".json")), name=name)


def limits(workload: str) -> dict:
    return _json(_named("cells", workload, ".json"))


def metric_reader(name: str):
    """The ``read(trace)`` of ``metrics/<name>.py``."""
    _named("metrics", name, ".py")
    return importlib.import_module(f"benchmark.metrics.{name}").read


def runner(name: str):
    """The module ``runners/<name>.py``."""
    _named("runners", name, ".py")
    return importlib.import_module(f"benchmark.runners.{name}")


def cell(workload: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark_json()
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def applies(m):
        return workload in m.get("workloads", [workload])

    return Cell(name=workload, chips=int(entry["chips"]),
                config=config(entry["config"]),
                traffic=traffic(entry["traffic"]), limits=limits(workload),
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)])
