"""The port's fuzz smoke suite (``repro_torch.bench.fuzz_smoke``) at
``smoke=True`` on the CPU: the differential stage over the reference
suite's 24 scenarios (seed 20260731) through the oracle and the plain
engine, 0 failures; and the batch-oracle stage over a fresh 300-case batch
and ``tests/corpus``, 0 divergences from the sequential oracle on the C
path.  The stage's throughput gate (the batch path at least 50× the
sequential cases a second) is timing, which a loaded test host does not
keep; it is asserted where the suite runs whole (``python -m
repro_torch.bench.fuzz_smoke``, and chip_smoke's ``fuzz_smoke`` phase on
the card's host).  The mutation self-tests are in
``test_torch_fuzz_smoke_mutation*.py``."""

import contextlib
import io

import pytest

torch = pytest.importorskip("torch")

from repro_torch.bench import fuzz_smoke  # noqa: E402
from repro_torch.sim.check import generate_batch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return {r.split(",")[0]: r.split(",", 2)[1:]
            for r in out.getvalue().splitlines()}, result


def test_cpu_runs_the_plain_engine_only():
    assert fuzz_smoke.device_modes("cpu") == ("torch",)


def test_differential_stage_has_no_failure():
    scenarios = generate_batch(fuzz_smoke.SMOKE_CASES, fuzz_smoke.SEED)
    rows, report = _rows(fuzz_smoke.run_differential, scenarios,
                         device="cpu")
    assert report.ok and report.n_cases == 24
    assert rows["fuzz/failures"][0] == "0"
    assert rows["fuzz/cases"] == [
        "24", "composed+random, seed=20260731, modes=torch"]
    assert int(rows["fuzz/oracle_events"][0]) == report.total_events > 0
    assert set(report.placements) <= {f"torch:{c}" for c in (1, 7, 16)}


def test_batch_oracle_stage_has_no_divergence():
    rows, gate = _rows(fuzz_smoke.batch_gate, fuzz_smoke.SMOKE_BENCH_CASES)
    assert gate["impl"] == "c"
    assert gate["divergences"] == 0 and gate["corpus_div"] == 0
    assert gate["n_corpus"] == 14
    assert rows["fuzz/batch_divergences"][0] == "0"
    assert rows["fuzz/corpus_divergences"][0] == "0"
    assert gate["seq_cps"] > 0 and gate["batch_cps"] > 0
