import json
import os
import re

import pytest

from benchmark import spec

BENCH = spec.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_by_name(w):
    c = spec.cell(w, BENCH)
    assert c.config["render"]["width"] and c.traffic["pitch"] is not None
    assert set(c.limits["limits"]) >= {"mesh_diff", "pixel_mismatch"}
    assert callable(spec.runner(c.config["runner"]).Runner)
    assert c.end_to_end and c.per_layer
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("m", [m["name"] for m in BENCH["per_layer"]])
def test_each_metric_has_a_reader(m):
    assert callable(spec.metric_reader(m))


def test_configs_files_and_names():
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        data = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert data["reduced"] == c["reduced"]
        assert len(data["source"]) <= 200


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    every = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    assert all(NAME.match(x["name"]) for x in every)
    assert len({x["name"] for x in every}) == len(every)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", [])) <= cells


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.cell("no_such.cell", BENCH)
    with pytest.raises(ValueError):
        spec.config("../BENCHMARK")
