"""The harness: find a cell by name, run it through its traffic's driver,
read its metrics, and build the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that ``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` — the configuration as it is run (the
  ``file`` of its entry in ``BENCHMARK.json``);
* ``traffic/<traffic>.json`` — the mix's parameters, and under ``driver``
  the general loop that runs it (``drivers/<driver>.py``);
* ``metrics/<metric>.py`` — one reader a metric, ``read(facts)`` returning
  a number or None when the run gave it nothing to read.

A driver's ``run(cell)`` returns an :class:`Outcome`: the facts its readers
take, the comparisons that decide ``correct``, and the device's readings.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# Top-level module names that no run may load (compared whole).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")


@dataclass
class Cell:
    """One cell as a driver runs it."""

    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = 0.0          # perf_counter at process start


@dataclass
class Check:
    """One number compared, beside its limit; ``ok`` when within it."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    facts: dict
    checks: list
    attempted: int
    failed: int
    setup_s: float
    memory_peak_bytes: int = 0
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None
    notes: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; options: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file, as its entry in ``BENCHMARK.json`` names
    it."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    with open(root / "chipbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metric_names(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``.  A metric with
    a ``workloads`` key is the listed cells'; an end-to-end metric without
    one is every cell's, and a per-layer metric without one is the cells'
    that report the end-to-end metric it moves."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e
                             else [])]


def units(bench: dict) -> dict:
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}


def _load(path: Path, module: str):
    """A module of the benchmark loaded from its file (a metric's name may
    hold dots; a checkout other than this one may add files)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = ROOT):
    """``drivers/<name>.py``: the loop a traffic file names."""
    return _load(root / "chipbench" / "drivers" / f"{name}.py",
                 f"chipbench.drivers.{name}")


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load(root / "chipbench" / "metrics" / f"{name}.py",
                 f"chipbench.metrics._{name.replace('.', '_')}").read


def read_metrics(names, facts: dict, unit_of: dict,
                 root: Path = ROOT) -> dict:
    """Each metric a reader finds something for, with its unit; a reader
    that returns None leaves its metric out."""
    out = {}
    for name in names:
        if name == "setup_s":
            continue
        value = reader(name, root)(facts)
        if value is not None:
            out[name] = {"value": float(value), "unit": unit_of[name]}
    return out


def run_cell(name: str, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float, root: Path = ROOT,
             config_patch: dict | None = None,
             traffic_patch: dict | None = None, control: bool = False):
    """Run the cell ``name`` once: ``(outcome, metrics, entry)``, the
    metrics those a run with ``trace`` reports (``setup_s`` among them
    with ``--trace 0``).  The patches replace top-level keys of the
    configuration and the traffic (the tests' small sizes); ``control``
    puts the check's control in the program's place."""
    spec = load_benchmark(root)
    entry = workload(spec, name)
    mix = {**traffic(entry["traffic"], root), **(traffic_patch or {})}
    cell = Cell(name=name,
                config={**config(spec, entry["config"], root),
                        **(config_patch or {})},
                traffic=mix, seed=seed, seconds=seconds, trace=trace,
                device=device, t_start=t_start)
    outcome = driver(mix["driver"], root).run(cell, control=control)
    metrics = read_metrics(metric_names(spec, name, trace), outcome.facts,
                           units(spec), root)
    if not trace:
        metrics["setup_s"] = {"value": outcome.setup_s, "unit": "s"}
    return outcome, metrics, entry


def forbidden_loaded(modules=None) -> list:
    """Loaded modules whose top-level name is one no run may load."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in list(modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def result_line(outcome: Outcome, metrics: dict, device: dict,
                trace: bool) -> dict:
    """The run's JSON result: the compared numbers come last, under
    ``checks``."""
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in outcome.checks}
    return line


def check_lines(outcome: Outcome) -> list:
    return [f"check {c.name} {c.value!r} limit {c.limit!r} "
            f"{'ok' if c.ok else 'FAILED'}" for c in outcome.checks]
