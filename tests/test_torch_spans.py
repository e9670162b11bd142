"""The port's span recorder (``repro_torch.spans``) and the spans of its
serve engine and sweep path, on the CPU: the recorder keeps nothing and
reads no clock while off; spans nest by thread, carry their request's id
and read ``time.perf_counter``; and the served tokens and sweep rows are
the same, bit for bit, with the recorder on and off; the serve profile's
prefill and decode seconds, read from the spans, are those its old
wrappers around ``_admit`` and ``step`` timed."""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.bench import serve_profile  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.sim import engine_cuda, workloads  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402

CPU = torch.device("cpu")
SWEEP_CHILDREN = {"sweep.build", "sweep.upload", "sweep.kernel",
                  "sweep.readback", "sweep.pad_stats", "sweep.rows"}


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.disable()
    spans.collect()
    yield
    spans.disable()
    spans.collect()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_id(recorded) -> dict:
    return {s.id: s for s in recorded}


def _children(recorded, parent) -> list:
    return [s for s in recorded if s.parent == parent.id]


# -- the recorder -------------------------------------------------------------

def test_off_keeps_nothing_and_reads_no_clock(monkeypatch):
    reads = []
    monkeypatch.setattr(spans, "_clock",
                        lambda: reads.append(1) or time.perf_counter())
    first, second = spans.span("a"), spans.span("b", rid=3)
    assert first is second and not first
    with first as sp:
        sp.count("k", 1)
        with spans.span("c"):
            pass
    assert reads == [] and spans.collect() == []
    spans.enable()
    with spans.span("e"):
        pass
    assert len(reads) == 2 and [s.name for s in spans.collect()] == ["e"]


def test_parents_follow_nesting_on_each_thread():
    spans.enable()
    with spans.span("outer") as outer:
        with spans.span("mid") as mid:
            with spans.span("inner") as inner:
                pass
        with spans.span("sibling") as sibling:
            pass
        other = []

        def work():
            with spans.span("elsewhere") as s:
                other.append(s)

        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert outer.parent is None and mid.parent == outer.id
    assert inner.parent == mid.id and sibling.parent == outer.id
    assert other[0].parent is None
    recorded = spans.collect()
    assert len({s.id for s in recorded}) == len(recorded) == 5
    assert [s.name for s in recorded] == ["inner", "mid", "sibling",
                                          "elsewhere", "outer"]
    for s in recorded:
        assert s.start <= s.end
        if s.parent is not None:
            p = _by_id(recorded)[s.parent]
            assert p.start <= s.start and s.end <= p.end


def test_counters_and_request_ids():
    spans.enable()
    with spans.span("admit", rid=7) as sp:
        sp.count("tokens", 12)
        sp.count("layout", "smem")
        with spans.span("prefill", rid=7) as prefill:
            pass
    with spans.span("step") as step:
        pass
    recorded = spans.collect()
    assert [s.rid for s in recorded] == [7, 7, None]
    admit = next(s for s in recorded if s.name == "admit")
    assert admit.counters == {"tokens": 12, "layout": "smem"}
    assert prefill.counters == step.counters == {}


def test_timestamps_are_perf_counter_readings():
    spans.enable()
    before = time.perf_counter()
    with spans.span("a") as a:
        inside = time.perf_counter()
    after = time.perf_counter()
    assert before <= a.start <= inside <= a.end <= after


def test_collect_drains():
    spans.enable()
    for name in ("a", "b"):
        with spans.span(name):
            pass
    assert [s.name for s in spans.collect()] == ["a", "b"]
    assert spans.collect() == []
    spans.disable()
    with spans.span("c"):
        pass
    assert spans.collect() == []


# -- the serve engine -----------------------------------------------------------

@pytest.fixture(scope="module", params=["falcon-mamba-7b", "deepseek-7b"])
def setup(request):
    cfg = get_config(request.param).reduced()
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)


PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9], [3, 2],
           [3, 8, 4, 6, 2, 6]]


def _serve(cfg, params):
    eng = ServeEngine(cfg, params, lanes=2, max_ctx=64, device=CPU)
    reqs = [eng.submit(p, max_new_tokens=3 + i % 3)
            for i, p in enumerate(PROMPTS)]
    while any(not r.done.is_set() for r in reqs):
        eng.step()
    return eng, reqs


def test_serve_spans(setup):
    cfg, params = setup
    spans.enable()
    eng, reqs = _serve(cfg, params)
    recorded = spans.collect()
    by_name = {}
    for s in recorded:
        by_name.setdefault(s.name, []).append(s)
    assert set(by_name) == {"serve.step", "serve.admit", "serve.prefill",
                            "serve.first_token", "serve.decode",
                            "serve.next_tokens"}
    steps = by_name["serve.step"]
    step_ids = {s.id for s in steps}
    # one admission a request, inside a step, before that step's decode
    admits = {s.rid: s for s in by_name["serve.admit"]}
    assert sorted(admits) == sorted(r.ticket for r in reqs)
    assert len(by_name["serve.admit"]) == eng.prefill_count == len(reqs)
    for r in reqs:
        a = admits[r.ticket]
        assert a.parent in step_ids
        kids = _children(recorded, a)
        assert [k.name for k in kids] == ["serve.prefill", "serve.first_token"]
        assert {k.rid for k in kids} == {r.ticket}
        assert a.start <= kids[0].start <= kids[0].end <= kids[1].start
        assert kids[1].end <= a.end
    # every step that decodes: its admissions, then one decode, then one
    # next_tokens, inside it
    decoding = 0
    for s in steps:
        kids = _children(recorded, s)
        names = [k.name for k in kids]
        n_admit = names.count("serve.admit")
        assert names[:n_admit] == ["serve.admit"] * n_admit
        if names[n_admit:] == []:
            continue
        decoding += 1
        assert names[n_admit:] == ["serve.decode", "serve.next_tokens"]
        for a, b in zip(kids, kids[1:]):
            assert s.start <= a.start <= a.end <= b.start <= b.end <= s.end
        assert s.counters == {}
    assert decoding == eng.step_count


def test_served_tokens_equal_with_the_recorder_on_and_off(setup):
    cfg, params = setup
    _, off = _serve(cfg, params)
    assert spans.collect() == []
    spans.enable()
    _, on = _serve(cfg, params)
    assert spans.collect()
    assert [r.tokens_out for r in on] == [r.tokens_out for r in off]
    assert ([r.admitted_at_step for r in on]
            == [r.admitted_at_step for r in off])


# -- the sweep path -------------------------------------------------------------

def _specs():
    return [workloads.SweepSpec(locks=("ticket", "twa"), threads=(2, 4),
                                seeds=(11,), horizon=1_500,
                                collect_latency=True),
            workloads.SweepSpec(locks=("mcs",), threads=(3,), seeds=(5, 6),
                                horizon=1_000)]


def test_sweep_spans_and_counters():
    spans.enable()
    launches = engine_cuda.launches
    out = workloads.run_sweeps(_specs(), device="cpu")
    recorded = spans.collect()
    (run,) = [s for s in recorded if s.name == "sweep.run"]
    assert run.parent is None
    kids = _children(recorded, run)
    assert {k.name for k in kids} == SWEEP_CHILDREN
    assert len(kids) == len(recorded) - 1
    assert [k.name for k in kids] == ["sweep.build", "sweep.upload",
                                      "sweep.kernel", "sweep.readback",
                                      "sweep.pad_stats", "sweep.rows"]
    for a, b in zip(kids, kids[1:]):
        assert run.start <= a.start <= a.end <= b.start <= b.end <= run.end
    rows = [r for rs in out for r in rs]
    assert len(rows) == 6
    pad = rows[0]["pad_stats"]
    assert run.counters == {"cells": 6,
                            "sum_events": pad["sum_events"],
                            "max_events": pad["max_events"]}
    assert pad["sum_events"] == sum(int(r["events"]) for r in rows)
    assert engine_cuda.launches == launches


def test_sweep_rows_equal_with_the_recorder_on_and_off():
    off = workloads.run_sweeps(_specs(), device="cpu")
    spans.enable()
    on = workloads.run_sweeps(_specs(), device="cpu")
    assert spans.collect()
    assert [len(rs) for rs in on] == [len(rs) for rs in off] == [4, 2]
    for a, b in zip((r for rs in on for r in rs),
                    (r for rs in off for r in rs)):
        assert a.keys() == b.keys()
        for k in a:
            assert _same(a[k], b[k]), k


def _same(a, b) -> bool:
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            _same(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    if isinstance(a, float) and np.isnan(a):
        return np.isnan(b)
    return type(a) is type(b) and a == b


# -- the serve profile ----------------------------------------------------------

def test_serve_profile_phases_match_the_wrapper_arithmetic(monkeypatch):
    """The serve profile's phases on a reduced model, against what its old
    wrappers around ``_admit`` and ``step`` gave on the same run: every
    admission is prefill, every step less the admissions inside it is
    decode."""
    timed, inside = {}, []

    def wrap(name, fn):
        def wrapped(self, *args):
            t = time.perf_counter()
            inside.append(name)
            out = fn(self, *args)
            inside.pop()
            if spans._on:                  # the profiled run, not warm-up
                key = name + ("_in_step" if "step" in inside else "")
                timed[key] = timed.get(key, 0.0) + time.perf_counter() - t
            return out
        return wrapped

    cls = serve_engine.ServeEngine
    monkeypatch.setattr(cls, "_admit", wrap("admit", cls._admit))
    monkeypatch.setattr(cls, "step", wrap("step", cls.step))
    monkeypatch.setattr(serve_profile, "get_config",
                        lambda arch: get_config(arch).reduced())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    row = serve_profile.serve(CPU, None, "falcon-mamba-7b")
    old_prefill = timed.get("admit", 0.0) + timed.get("admit_in_step", 0.0)
    old_decode = timed["step"] - timed.get("admit_in_step", 0.0)
    assert row["prefills"] == 8 and row["decode_steps"] > 0
    assert 0 < row["prefill_s"] and 0 < row["decode_s"]
    assert row["prefill_s"] + row["decode_s"] <= row["wall_s"]
    # each span lies inside its wrapper, which adds a few calls around it
    for new, old in ((row["prefill_s"], old_prefill),
                     (row["decode_s"], old_decode)):
        assert abs(old - new) <= 0.005 + 0.05 * old, (old, new)
    assert row["decode_ms_per_step"] == pytest.approx(
        1e3 * row["decode_s"] / row["decode_steps"])
    assert row["device_busy_s"] == 0 and row["port_kernels"] == {}
