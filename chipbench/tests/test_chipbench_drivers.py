"""Each driver end to end at a small size on the CPU, and the check
catching a timed path broken underneath it."""

from __future__ import annotations

import math

import numpy as np
import pytest

from chipbench.tests import tiny

SWEEP = "lockvm-64t.mutexbench"
SERVE = "falcon-mamba-7b.code-batch"
INTERLOCK = {"horizon": 1500, "calls": [[{
    "locks": ["twa"], "threads": [8], "seeds": 1, "cs_work": 50,
    "ncs_max": 100, "n_locks": 8, "private_arrays": [False, True]}]]}


@pytest.mark.parametrize("cell,traffic", (
    (SWEEP, None), ("lockvm-64t.interlock", INTERLOCK), (SERVE, tiny.OPEN),
    (SERVE, tiny.CLOSED)), ids=("mutexbench", "interlock", "open", "closed"))
def test_cell_runs_correct_on_the_cpu(cell, traffic):
    out, metrics, entry = tiny.run(cell, seed=2**31 + 5, traffic=traffic)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert "setup_s" in metrics and len(metrics) >= 2
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in metrics.values())


@pytest.mark.parametrize("cell", (SWEEP, SERVE))
def test_the_control_comes_out_not_correct(cell):
    """The control judged in the program's place fails the check, while
    the program's own readings in the same run pass."""
    out, _, _ = tiny.run(cell, seed=2**31 + 7, control=True)
    assert not out.correct, out.checks
    assert out.checks and all(not c.ok for c in out.checks)
    limits = {c.name: c.limit for c in out.checks}
    assert all(out.notes["program"][k] <= v for k, v in limits.items())


def test_same_seed_same_inputs():
    from chipbench.drivers import serve

    traffic = {**tiny.SERVE_TRAFFIC, "loop": "open"}

    def draw(seed, n):
        requests = serve.Requests(traffic, seed, 512)
        return [requests.next() for _ in range(n)]

    a, b, c = draw(99, 64), draw(99, 64), draw(2**31 + 98, 64)
    assert a == b

    def sizes(reqs):
        return (sorted(len(p) for p, _, _ in reqs),
                sorted(n for _, n, _ in reqs), sorted(g for _, _, g in reqs))

    # each block of 32: the same sizes and gaps on every seed, in an
    # order the seed draws; each run of 8 holds one of every eighth
    assert sizes(a[:32]) == sizes(c[:32]) == sizes(a[32:])
    assert [len(p) for p, _, _ in a[:32]] != [len(p) for p, _, _ in c[:32]]
    assert [p for p, _, _ in a[:32]] != [p for p, _, _ in c[:32]]
    eighths = np.sort(sizes(a[:32])[2]).reshape(8, 4)
    for run in range(4):
        gaps = [g for _, _, g in a[8 * run:8 * run + 8]]
        assert sorted(int(np.searchsorted(eighths[:, -1], g))
                      for g in gaps) == list(range(8))


def test_lengths_are_the_sources_log_normal():
    from chipbench.drivers import serve

    sizes = serve.lognormal_sizes(
        {"median": 1500, "sigma": 1.0, "min": 64, "max": 16384}, 32)
    assert sizes.min() >= 64 and sizes.max() <= 16384
    assert abs(np.median(sizes) - 1500) < 60
    assert sizes.max() > 7 * np.median(sizes)       # a heavy tail


def _run(cell, traffic=None):
    out, _, _ = tiny.run(cell, seconds=1.5, traffic=traffic)
    return out


# Each fault breaks the timed path under the harness; the check must
# come out not correct.
def _sweep_unchanged(run_sweep):
    def broken(programs, **kw):
        res = run_sweep(programs, **kw)
        for k in ("acquisitions", "waited_acquisitions", "handover_sum",
                  "handover_count", "events", "sleeping", "lat_hist"):
            res[k] = np.zeros_like(res[k])
        res["grant_value"] = np.asarray(kw["init_mem"]).copy()
        return res
    return broken


def _sweep_half(run_sweep):
    def broken(programs, **kw):
        res = run_sweep(programs, **kw)
        half = len(programs) // 2
        for k in ("acquisitions", "waited_acquisitions", "handover_sum",
                  "handover_count", "events", "sleeping", "grant_value",
                  "lat_hist"):
            res[k][half:] = res[k][:len(programs) - half]
        return res
    return broken


def _sweep_altered(run_sweep):
    def broken(programs, **kw):
        res = run_sweep(programs, **kw)
        res["acquisitions"][:, 0] += 1
        return res
    return broken


@pytest.mark.parametrize("fault", (_sweep_unchanged, _sweep_half,
                                   _sweep_altered))
def test_sweep_check_catches(monkeypatch, fault):
    from repro_torch.sim import engine

    monkeypatch.setattr(engine, "run_sweep", fault(engine.run_sweep))
    out = _run(SWEEP)
    assert not out.correct


def _decode_unchanged(decode_step):
    def broken(params, cache, *a, **kw):
        saved = {j: {k: v.clone() for k, v in slot.items()}
                 for j, slot in cache["stack"].items()}
        logits, cache = decode_step(params, cache, *a, **kw)
        for j, slot in saved.items():
            for k, v in slot.items():
                cache["stack"][j][k].copy_(v)
        return logits, cache
    return broken


def _decode_half(decode_step):
    def broken(params, cache, tokens, pos, *a, **kw):
        logits, cache = decode_step(params, cache, tokens, pos, *a, **kw)
        half = logits.shape[0] // 2
        logits[half:] = logits[:logits.shape[0] - half].clone()
        return logits, cache
    return broken


def _sample_altered(sample):
    def broken(logits, *a, **kw):
        return (sample(logits, *a, **kw) + 1) % logits.shape[-1]
    return broken


@pytest.mark.parametrize("fault,target,traffic", (
    (_decode_unchanged, "decode_step", tiny.OPEN),
    (_decode_half, "decode_step", tiny.CLOSED),     # every lane busy
    (_sample_altered, "sample", tiny.OPEN)))
def test_serve_check_catches(monkeypatch, fault, target, traffic):
    from repro_torch.serve import engine

    monkeypatch.setattr(engine, target, fault(getattr(engine, target)))
    out = _run(SERVE, traffic)
    assert not out.correct
    assert out.checks[0].name == "served_gap" and not out.checks[0].ok


def test_knee_rung_on_the_cpu():
    import time

    from chipbench import bench, knee

    spec = bench.load_benchmark()
    serve = bench.driver("serve")
    cell = bench.Cell(
        name="falcon-mamba-7b.code-poisson",
        config={**bench.config(spec, "falcon-mamba-7b"), **tiny.SERVE_CONFIG},
        traffic={**bench.traffic("code-poisson"), **tiny.SERVE_TRAFFIC,
                 "rate_per_s": 10.0},
        seed=1, seconds=1.0, trace=False, device="cpu",
        t_start=time.perf_counter())
    row = knee.rung(cell, serve.build(cell)[0], serve)
    assert row["sustained"] and row["offered"] > 0
    assert row["admitted"] >= row["offered"]
