"""On the card: the traced path, and the serve check's control at a size
a test run can hold.  Each test decides inside whether a card is here."""

from __future__ import annotations

import time

import pytest

from chipbench import bench
from chipbench.tests import tiny


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ("lockvm-64t.mutexbench",
                                  "falcon-mamba-7b.code-batch"))
def test_traced_run_reads_the_device(cell):
    _card()
    config, traffic = tiny.patches(cell)
    out, metrics, _ = bench.run_cell(
        cell, seed=3, seconds=2.0, trace=True, device="cuda",
        t_start=time.perf_counter(), config_patch=config,
        traffic_patch=traffic)
    assert out.correct, out.checks
    assert 0 < out.busy_s <= out.window_s
    assert out.breakdown["device_ops"]
    names = bench.metric_names(bench.load_benchmark(), cell, trace=True)
    assert set(metrics) == set(names)


@pytest.mark.cuda
def test_serve_control_fails_where_the_program_passes():
    """Four full-width layers in bf16: the check judging the float8
    control comes out not correct, its widest served gap at least three
    times the program's at the same positions."""
    _card()
    cell = "falcon-mamba-7b.code-batch"
    spec = bench.load_benchmark()
    config = bench.config(spec, "falcon-mamba-7b")
    config = {**config, "arch": {**config["arch"], "n_layers": 4}}
    mix = bench.traffic(bench.workload(spec, cell)["traffic"])
    mix = {"prompt_tokens": {**mix["prompt_tokens"], "max": 2048},
           "lead_s": 2.0}
    for seed in (1, 2, 3):
        out, _, _ = bench.run_cell(
            cell, seed=seed, seconds=5.0, trace=False,
            t_start=time.perf_counter(), config_patch=config,
            traffic_patch=mix, control=True)
        assert not out.correct, out.checks
        program = out.notes["program"]["served_gap"]
        assert out.checks[0].value >= 3 * program, out.notes
