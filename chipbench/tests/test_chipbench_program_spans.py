"""The program's spans in the benchmark (``chipbench/program_spans.py``)
and the readers of the metrics built on them, against hand-worked values,
and against the spans the program records on the CPU."""

from __future__ import annotations

import sys
import time

import pytest

from chipbench import bench, program_spans as ps, trace as tr
from chipbench.tests import tiny  # noqa: F401  (puts the program on the path)


def read(name, facts):
    return bench.reader(name)(facts)


def span(name, start, end, id, parent=None, rid=None, **counters):
    return {"name": name, "start": start, "end": end, "id": id,
            "parent": parent, "rid": rid, "counters": counters}


# One engine step (host seconds 0.5-9.5) that admits ticket 4 and decodes,
# inside the benchmark's own spans around its calls.
OWN = tr.Spans([("step", 0.0, 10.0), ("prefill", 1.0, 4.0)])
SERVE = [
    span("serve.prefill", 1.6, 3.0, 3, parent=2, rid=4),
    span("serve.first_token", 3.0, 3.4, 4, parent=2, rid=4),
    span("serve.admit", 1.5, 3.5, 2, parent=5, rid=4),
    span("serve.decode", 5.0, 6.0, 6, parent=5),
    span("serve.next_tokens", 6.0, 9.0, 7, parent=5),
    span("serve.step", 0.5, 9.5, 5),
]


def test_idle_gaps_take_the_innermost_program_span():
    spans = ps.labelled(OWN, SERVE)
    points = [0.1, 0.3, 0.7, 1.2, 1.55, 2.0, 3.2, 3.45, 3.7, 4.5, 5.5, 7.0,
              9.7, 10.5]
    assert tr._labels(spans, points) == [
        "step", "step", "serve.step", "prefill", "serve.admit",
        "serve.prefill", "serve.first_token", "serve.admit", "prefill",
        "serve.step", "serve.decode", "serve.next_tokens", "step", "harness"]
    # the benchmark's own spans are left as they were
    assert OWN.items == [("step", 0.0, 10.0), ("prefill", 1.0, 4.0)]


def test_breakdown_names_idle_by_program_span():
    ops = [("k", 1.6, 2.6), ("k", 5.2, 5.3), ("k", 6.1, 8.6)]
    out = tr.breakdown(ops, ps.labelled(OWN, SERVE), 0.0, 10.0)
    # each gap takes the label at its middle: 0-1.6 (0.8), 2.6-5.2 (3.9),
    # 5.3-6.1 (5.7), 8.6-10 (9.3)
    idle = dict(out["idle_gaps"])
    assert idle.keys() == {"serve.step", "prefill", "serve.decode"}
    assert idle == pytest.approx({"serve.step": 1.6 + 1.4, "prefill": 2.6,
                                  "serve.decode": 0.8})


def test_serve_facts_and_readers():
    # busy 1.6-2.6 inside the admission; 5.2-5.3 and 6.1-8.6 inside the
    # decode step (5.0-9.0); one op outside the window
    ops = [("a", 1.6, 2.0), ("b", 1.9, 2.6), ("c", 5.2, 5.3),
           ("d", 6.1, 8.6), ("e", 10.5, 11.0)]
    facts = ps.serve_facts(SERVE, ops, 0.0, 10.0)
    assert facts["decode_steps"] == 1
    assert facts["decode_enqueue_ms"] == pytest.approx([1000.0])
    assert facts["decode_span_s"] == pytest.approx(4.0)
    assert facts["decode_idle_s"] == pytest.approx(4.0 - 0.1 - 2.5)
    assert facts["decode_ops"] == 2
    assert facts["prefill_span_s"] == pytest.approx(2.0)
    assert facts["prefill_idle_s"] == pytest.approx(2.0 - 1.0)
    assert read("decode_enqueue_ms", facts) == pytest.approx(1000.0)
    assert read("decode_idle_pct", facts) == pytest.approx(35.0)
    assert read("decode_ops_per_step", facts) == 2
    assert read("prefill_idle_pct", facts) == pytest.approx(50.0)
    # spans that cross the window's ends are not the window's
    assert ps.serve_facts(SERVE, ops, 1.0, 10.0) == {}


def test_decode_readers_take_the_median_and_the_sums():
    facts = {"decode_steps": 4, "decode_enqueue_ms": [9.0, 7.0, 8.0, 30.0],
             "decode_span_s": 0.5, "decode_idle_s": 0.1, "decode_ops": 1000}
    assert read("decode_enqueue_ms", facts) == 8.0
    assert read("decode_idle_pct", facts) == pytest.approx(20.0)
    assert read("decode_ops_per_step", facts) == 250.0
    for name in ("decode_enqueue_ms", "decode_idle_pct",
                 "decode_ops_per_step", "prefill_idle_pct"):
        assert read(name, {"window_s": 1.0}) is None


def test_busy_intervals_against_a_loop():
    ops = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 3.5),
           ("d", 3.2, 3.3), ("e", 5.0, 9.0)]
    busy = ps.Busy(ops, 0.0, 8.0)
    step = 0.001
    for a, b in [(0.2, 0.7), (1.5, 3.1), (2.0, 3.0), (3.4, 6.0), (6.0, 8.0),
                 (9.0, 9.5)]:
        n = round((b - a) / step)
        grid = [a + (i + 0.5) * step for i in range(n)]
        want = sum(step for t in grid if any(s <= t < e for _, s, e in
                                             tr.clip(ops, 0.0, 8.0)))
        assert busy.busy_s(a, b) == pytest.approx(want, abs=2 * step)
    assert busy.ops_starting(0.0, 3.2) == 3
    assert busy.ops_starting(3.2, 8.0) == 2


SWEEP = [
    span("sweep.build", 1.0, 1.2, 2, parent=1),
    span("sweep.upload", 1.2, 1.3, 3, parent=1),
    span("sweep.kernel", 1.3, 1.31, 4, parent=1),
    span("sweep.readback", 1.31, 1.9, 5, parent=1),
    span("sweep.pad_stats", 1.9, 1.92, 9, parent=1),
    span("sweep.rows", 1.92, 1.95, 6, parent=1),
    span("sweep.run", 1.0, 2.0, 1, cells=291, sum_events=60_000_000,
         max_events=1_600_000),
    span("sweep.build", 2.0, 2.3, 8, parent=7),
    span("sweep.run", 2.0, 3.0, 7, cells=12, sum_events=4_000_000,
         max_events=1_000_000),
]


def test_sweep_facts_and_readers():
    facts = ps.sweep_facts(SWEEP, 0.0, 5.0)
    assert facts["sweep_build_s"] == pytest.approx(0.5)
    assert facts["sweep_events"] == 64_000_000
    assert facts["sweep_cell_slots"] == 291 * 1_600_000 + 12 * 1_000_000
    facts["passes"] = 2
    assert read("sweep_build_ms", facts) == pytest.approx(250.0)
    assert read("lockvm_cell_occupancy_pct", facts) == pytest.approx(
        100 * 64e6 / (465.6e6 + 12e6))
    assert ps.sweep_facts(SWEEP, 2.5, 5.0) == {}
    assert read("sweep_build_ms", {"passes": 2}) is None
    assert read("lockvm_cell_occupancy_pct", {"passes": 2}) is None
    # the sweep's spans nest inside the benchmark's run_sweeps
    own = tr.Spans([("run_sweeps", 0.9, 2.05), ("run_sweeps", 1.99, 3.1)])
    assert tr._labels(ps.labelled(own, SWEEP), [0.95, 1.5, 1.97, 2.02, 2.5]
                      ) == ["run_sweeps", "sweep.readback", "sweep.run",
                            "sweep.run", "sweep.run"]


@pytest.fixture(autouse=True)
def _recorder_off():
    yield
    from repro_torch import spans
    spans.disable()
    spans.collect()


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    import repro_torch
    import repro_torch.spans  # noqa: F401

    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert ps.start() is False and ps.stop() == []
    assert ps.serve_facts([], [], 0.0, 1.0) == {}
    assert ps.sweep_facts([], 0.0, 1.0) == {}


def test_the_program_spans_on_the_cpu():
    """The names and counters the facts read are the ones the program
    records: a small serve and a small sweep with the recorder on."""
    import torch
    from repro_torch import spans
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServeEngine
    from repro_torch.sim import workloads

    cfg = ArchConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in tiny.ARCH.items()})
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device=torch.device("cpu"))
    eng = ServeEngine(cfg, params, lanes=2, max_ctx=32, device="cpu")
    with spans.span("left over"):
        pass
    assert ps.start() is True
    w0 = time.perf_counter()
    reqs = [eng.submit([1 + i, 2, 3], max_new_tokens=3) for i in range(3)]
    while not all(r.done.is_set() for r in reqs):
        eng.step()
    rows = workloads.run_sweeps([workloads.SweepSpec(
        locks=("twa",), threads=(2, 3), seeds=(9,), horizon=800)],
        device="cpu")[0]
    w1 = time.perf_counter()
    program = ps.stop()
    with spans.span("after") as sp:
        assert not sp
    assert "left over" not in {s["name"] for s in program}
    facts = ps.serve_facts(program, [], w0, w1)
    assert facts["decode_steps"] == eng.step_count
    assert facts["decode_idle_s"] == pytest.approx(facts["decode_span_s"])
    assert facts["decode_ops"] == 0
    assert len(ps.within(program, "serve.admit", w0, w1)) == 3
    (run,) = ps.within(program, "sweep.run", w0, w1)
    assert set(run["counters"]) == {"cells", "sum_events", "max_events"}
    facts = ps.sweep_facts(program, w0, w1)
    assert facts["sweep_events"] == sum(int(r["events"]) for r in rows)
    assert facts["sweep_cell_slots"] == 2 * max(int(r["events"])
                                                for r in rows)
