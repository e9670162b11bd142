"""The fuzz smoke suite's mutation self-test (``eager_store``) through the
sequential oracle, on the CPU at ``smoke=True``: the port catches it on
as many of the 24 scenarios as the reference's ``fuzz(scenarios,
modes=("map",), oracle_mutate=("eager_store",))`` does on the same ones.
The batch-oracle leg is ``test_torch_fuzz_smoke_mutation_batch.py``."""

import contextlib
import io

import pytest

torch = pytest.importorskip("torch")

from repro.sim import check as ref_check  # noqa: E402
from repro_torch.bench import fuzz_smoke  # noqa: E402
from repro_torch.sim.check import generate_batch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_mutation_count(batch_oracle: bool):
    """The port's mutation stage catches what the reference's does."""
    row = ("fuzz/mutation_caught_batch" if batch_oracle
           else "fuzz/mutation_caught")
    scenarios = generate_batch(fuzz_smoke.SMOKE_CASES, fuzz_smoke.SEED)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mutated = fuzz_smoke.run_mutation(scenarios,
                                          batch_oracle=batch_oracle,
                                          device="cpu")
    ref = ref_check.fuzz(
        ref_check.generate_batch(fuzz_smoke.SMOKE_CASES, fuzz_smoke.SEED),
        modes=("map",), oracle_mutate=("eager_store",),
        batch_oracle=batch_oracle)
    assert len(ref.failures) > 0
    assert len(mutated.failures) == len(ref.failures)
    assert [i for i, *_ in mutated.failures] == \
        [i for i, *_ in ref.failures]
    assert out.getvalue().startswith(f"{row},{len(ref.failures)},")


def test_mutation_caught_matches_the_reference():
    assert_mutation_count(batch_oracle=False)
