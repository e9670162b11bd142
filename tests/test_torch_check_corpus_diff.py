"""The corpus builder's ``diff_lost_wake`` and ``diff_free_invalidation``
entries, the port's against the reference's, both run here (the reference
builds the family's first entry too; ``diff_eager_store`` is compared in
``test_torch_check_corpus_eager.py``)."""

import pytest

torch = pytest.importorskip("torch")

from repro.sim.check import make_corpus as ref_make_corpus  # noqa: E402
from repro_torch.sim.check import make_corpus  # noqa: E402
from test_torch_check_corpus import assert_same_build  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain engine's tensors are small: one intra-op thread per test
    worker is faster than many contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_corpus_writes_the_reference_diff_entries(tmp_path):
    mutations = ("lost_wake", "free_invalidation")
    assert mutations == make_corpus.DIFF_MUTATIONS[1:]
    built = assert_same_build(
        lambda out: [make_corpus.make_diff_entry(out, m, "cpu")
                     for m in mutations],
        ref_make_corpus.make_diff_entries, tmp_path)
    assert list(built) == ["diff_free_invalidation", "diff_lost_wake"]
