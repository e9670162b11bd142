"""The metric arithmetic against hand-worked values."""

from __future__ import annotations

import math

import pytest

from chipbench import bench, trace as tr, work
from chipbench.drivers import serve
from chipbench.tests import tiny  # noqa: F401  (puts the program on the path)

FALCON = bench.config(bench.load_benchmark(), "falcon-mamba-7b")["arch"]


def read(name, facts):
    return bench.reader(name)(facts)


def test_nearest_rank():
    values = list(range(1, 101))             # 1..100
    assert tr.nearest_rank(values, 0.90) == 90
    assert tr.nearest_rank(values, 0.95) == 95
    assert tr.nearest_rank([5.0], 0.9) == 5.0
    assert tr.nearest_rank([3, 1, 2], 0.5) == 2
    assert tr.nearest_rank([], 0.9) is None


def test_events_per_second():
    assert read("sim_events_per_s", {"events": 73_000_000,
                                     "window_s": 2.0}) == 36_500_000
    assert read("sim_events_per_s", {}) is None


def test_sweep_readers():
    facts = {"passes": 4, "sweep_wall_s": 3.4, "kernel_s": 3.0,
             "longest_events": 6_000_000, "busy_s": 3.1,
             "trace_window_s": 3.5}
    assert read("sweep_host_ms", facts) == pytest.approx(100.0)
    assert read("lockvm_ns_per_event", facts) == pytest.approx(500.0)
    assert read("device_idle_pct.sim", facts) == pytest.approx(
        (1 - 3.1 / 3.5) * 100)
    assert read("sweep_host_ms", {"passes": 4}) is None


def test_falcon_flops_a_token():
    # per layer: 2 x (4096*16384 + 8192*288 + 256*8192 + 8192*4096)
    # + 2*8192*4 (conv) + 7*8192*16 + 2*8192 (scan)
    per_layer = 2 * 105_119_744 + 65_536 + 917_504 + 16_384
    assert work.mamba_token_flops(FALCON) == 64 * per_layer
    assert work.mamba_head_flops(FALCON) == 2 * 4096 * 65024
    assert work.prefill_flops(FALCON, 1000) == (
        1000 * 64 * per_layer + 2 * 4096 * 65024)
    assert work.decode_flops(FALCON, 3) == 3 * (
        64 * per_layer + 2 * 4096 * 65024)


def test_scan_bound():
    # 256 steps, D 8,192, N 16, bf16: 13,139,968 bytes over 3.35e12 B/s
    # (0.0039 ms, as kernel_bounds gives), above 239,075,328 ops at 67e12
    assert work.scan_bound_s(256, 8192, 16) == pytest.approx(
        13_139_968 / 3.35e12)
    # a shape bound by its operations: N 64
    assert work.scan_bound_s(1000, 1000, 64) == pytest.approx(
        (7 * 1000 * 1000 * 64 + 2 * 1000 * 1000) / 67e12)


def test_mfu_and_roofline_readers():
    facts = {"model_flops": 989e12 * 0.5, "window_s": 2.0,
             "scan_bound_s": 0.25, "scan_kernel_s": 1.0}
    assert read("serve_mfu_pct.rate", facts) == pytest.approx(25.0)
    assert read("serve_mfu_pct.batch", facts) == pytest.approx(25.0)
    assert read("mamba_scan_roofline", facts) == pytest.approx(25.0)
    assert read("mamba_scan_roofline", {"scan_kernel_s": 0.0}) is None


class _Req:
    def __init__(self, prompt):
        self.prompt = [0] * prompt


class _Loop:
    """What window_facts reads of a serve loop."""

    def __init__(self, records, admissions, steps):
        self.records, self.steps = records, steps
        self.eng = type("E", (), {"admissions": admissions})()


def test_serve_window_facts():
    w0, w1 = 10.0, 20.0
    records = [
        # due in the window, first token 0.5 s later, then two tokens
        {"due": 11.0, "stamps": [11.5, 11.7, 12.0]},
        # due in the window, never answered: its wait until w1 counts
        {"due": 19.0, "stamps": []},
        # due before the window: no TTFT; its later gaps count
        {"due": 9.0, "stamps": [9.5, 10.5]},
    ]
    admissions = [(0, 11.2, 11.5, 1000), (1, 9.3, 9.5, 2000)]
    steps = [(12.0, 12.2, 0, 4), (12.2, 12.9, 1, 4), (9.0, 9.4, 0, 4)]
    f = serve.window_facts(_Loop(records, admissions, steps), FALCON, w0, w1)
    assert f["ttft_ms"] == pytest.approx([500.0, 1000.0])
    assert sorted(f["itl_ms"]) == pytest.approx([200.0, 300.0, 1000.0])
    assert f["generated_tokens"] == 4
    assert f["prompt_tokens"] == 1000
    assert f["decode_only_step_ms"] == pytest.approx([200.0])
    assert f["prefill_ms"] == pytest.approx([300.0])
    assert f["model_flops"] == pytest.approx(
        work.prefill_flops(FALCON, 1000) + work.decode_flops(FALCON, 3))
    assert read("ttft_p90_ms", f) == pytest.approx(1000.0)
    assert read("itl_p95_ms", f) == pytest.approx(1000.0)
    assert read("tokens_per_s", f) == pytest.approx((1000 + 4) / 10.0)
    assert read("decode_step_ms", f) == pytest.approx(200.0)
    assert read("prefill_ms_per_ktok", f) == pytest.approx(300.0)


def test_trace_arithmetic():
    ops = [("k1", 0.0, 1.0), ("k2", 0.5, 1.5), ("k1", 3.0, 4.0),
           ("copy", 6.0, 7.0)]
    assert tr.busy_intervals(ops) == [(0.0, 1.5), (3.0, 4.0), (6.0, 7.0)]
    assert tr.busy_seconds(ops, 1.0, 6.5) == pytest.approx(0.5 + 1.0 + 0.5)
    assert tr.kernel_seconds(ops, 0.0, 10.0, "k1") == pytest.approx(2.0)
    assert tr.idle_gaps(ops, 0.0, 8.0) == [(1.5, 3.0), (4.0, 6.0),
                                           (7.0, 8.0)]
    spans = tr.Spans()
    spans.add("step", 1.0, 6.0)
    spans.add("prefill", 4.5, 5.5)
    b = tr.breakdown(ops, spans, 0.0, 8.0)
    assert b["device_ops"][0] == ["k1", 2.0]
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"step": 1.5, "prefill": 2.0, "harness": 1.0})
    assert tr.idle_pct({"busy_s": 3.0, "trace_window_s": 4.0}) == 25.0
    assert math.isclose(tr.idle_pct({"busy_s": 0.0,
                                     "trace_window_s": 2.0}), 100.0)
