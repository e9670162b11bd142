"""BENCHMARK.json against the contract's shape, and the harness finding
every configuration, mix, metric and cell by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from chipbench import bench
from chipbench.tests import tiny

SPEC = bench.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["chipbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (bench.ROOT / c["file"]).is_file()
        assert c["file"].startswith("chipbench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_found_by_name(cell):
    entry = bench.workload(SPEC, cell)
    config = bench.config(SPEC, entry["config"])
    mix = bench.traffic(entry["traffic"])
    assert bench.driver(mix["driver"]).run
    e2e = bench.metric_names(SPEC, cell, trace=False)
    per_layer = bench.metric_names(SPEC, cell, trace=True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for name in e2e + per_layer:
        if name != "setup_s":
            assert callable(bench.reader(name))
    assert config["reduced"] == next(
        c["reduced"] for c in SPEC["configs"] if c["name"] == entry["config"])


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        bench.workload(SPEC, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such_metric")


def test_a_cell_added_from_new_files_alone(tmp_path):
    """A copy of the benchmark gains a mix, a metric and a cell by new
    files and entries only, and the harness runs it."""
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    mix = {"driver": "lockvm_sweep", "horizon": 1500,
           "calls": [[{"locks": ["mcs"], "threads": [2, 8], "seeds": 1}]],
           "check_events": 10 ** 9}
    (tmp_path / "chipbench/traffic/mcs-small.json").write_text(
        json.dumps(mix))
    (tmp_path / "chipbench/metrics/passes_per_s.py").write_text(
        "def read(facts):\n"
        "    return facts['passes'] / facts['window_s']\n")
    spec["workloads"].append({"name": "lockvm-64t.mcs-small",
                              "config": "lockvm-64t",
                              "traffic": "mcs-small", "chips": 1,
                              "why": "a test cell"})
    spec["end_to_end"].append({"name": "passes_per_s", "unit": "1/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["lockvm-64t.mcs-small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out, metrics, _ = bench.run_cell(
        "lockvm-64t.mcs-small", seed=7, seconds=0.5, trace=False,
        device="cpu", t_start=0.0, root=tmp_path,
        config_patch=tiny.LOCKVM_CONFIG)
    assert out.correct
    assert set(metrics) == {"passes_per_s", "setup_s"}
    assert metrics["passes_per_s"]["value"] > 0
