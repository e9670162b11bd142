"""The port's shrinker (``repro_torch.sim.check.shrink``) on the CPU with
the plain engine: the reference's self-tests of ``tests/test_check_fuzz.py``
and ``tests/test_results_store.py``, run through the port's runner.

The plain engine pays about a millisecond a step on the CPU and a shrink
runs it once per candidate, so each shrink here starts from a 300-cycle
horizon (the shrinker's first pass halves the horizon anyway).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.sim import engine  # noqa: E402
from repro_torch.sim.check import (case_problems, count_instructions,  # noqa: E402,E501
                                   failure_classes, fuzz, generate_batch,
                                   shrink)
from repro_torch.sim.faults import F_PREEMPT, F_SPURIOUS  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain engine's tensors are small: one intra-op thread per test
    worker is faster than many contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pinned(batch, chunk=engine.DEFAULT_TORCH_CHUNK):
    """``batch`` with every case pinned to one chunk: one dispatch of the
    plain engine."""
    return [s.replace(meta={**s.meta, "torch_chunk": chunk}) for s in batch]


def test_eager_store_witness_shrinks_to_a_dozen_instructions():
    """The reference's mutation self-test: a store-visibility bug caught on
    a fresh batch shrinks to <= 12 instructions that still witness it and
    are clean without it."""
    batch = _pinned(generate_batch(24, 123))
    report = fuzz(batch, modes=("torch",), device="cpu",
                  oracle_mutate=("eager_store",), batch_oracle=True)
    assert not report.ok
    for _idx, s, problems in report.failures:
        assert "differential" in failure_classes(problems)
        short = s.replace(horizon=300, max_events=1_200)
        if "differential" in failure_classes(case_problems(
                short, oracle_mutate=("eager_store",), device="cpu")):
            break
    else:
        pytest.fail("no witness fails at a 300-cycle horizon")
    shrunk = shrink(short, modes=("torch",), oracle_mutate=("eager_store",),
                    device="cpu")
    assert count_instructions(shrunk.program) <= 12
    assert shrunk.meta["torch_chunk"] == engine.DEFAULT_TORCH_CHUNK
    still = case_problems(shrunk, oracle_mutate=("eager_store",),
                          device="cpu")
    assert "differential" in failure_classes(still)
    clean = case_problems(shrunk, device="cpu")
    assert "differential" not in failure_classes(clean)


def test_dropped_fault_shrinks_to_the_fault_that_matters():
    """The reference's fault-schedule minimization: rows scheduled past the
    run's last event never fire and are dropped; the one that matters
    stays, its stall width halved toward minimal."""
    for s in _pinned(generate_batch(24, 5, fault_fraction=0.5)):
        if s.kind != "composed" or s.n_active < 3:
            continue
        s = s.replace(horizon=300, max_events=1_200)
        dead = s.max_events - 1
        rows = [[F_PREEMPT, 40, 0, 2048], [F_PREEMPT, dead - 1, 1, 64],
                [F_SPURIOUS, dead, 2, 0]]
        s = s.replace(meta={**s.meta, "faults": rows, "torch_chunk": 16})
        if failure_classes(case_problems(
                s, oracle_mutate=("dropped_fault",), device="cpu")) \
                == {"differential"}:
            break
    else:
        pytest.fail("no case where the dropped preemption shows")
    small = shrink(s, oracle_mutate=("dropped_fault",), device="cpu",
                   program_passes=False)
    after = small.meta["faults"]
    assert len(after) == 1 and after[0][:3] == [F_PREEMPT, 40, 0], after
    assert 1 <= after[0][3] <= 2048
    assert small.horizon < s.horizon
