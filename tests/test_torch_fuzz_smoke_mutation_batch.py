"""The fuzz smoke suite's mutation self-test through the batch oracle, on
the CPU at ``smoke=True``: the port catches ``eager_store`` on as many of
the 24 scenarios as the reference's ``fuzz(..., modes=("map",),
oracle_mutate=("eager_store",), batch_oracle=True)`` does on the same
ones."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_fuzz_smoke_mutation import assert_mutation_count  # noqa: E402,E501


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mutation_caught_batch_matches_the_reference():
    assert_mutation_count(batch_oracle=True)
