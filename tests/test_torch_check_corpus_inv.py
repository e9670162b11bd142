"""The corpus builder's ``inv_*`` entries (deliberately broken locks,
shrunk while the checker keeps flagging them), the port's against the
reference's, both run here."""

import pytest

torch = pytest.importorskip("torch")

from repro.sim.check import make_corpus as ref_make_corpus  # noqa: E402
from repro_torch.sim.check import make_corpus  # noqa: E402
from test_torch_check_corpus import FAMILIES, assert_same_build  # noqa: E402,E501


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain engine's tensors are small: one intra-op thread per test
    worker is faster than many contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_corpus_writes_the_reference_invariant_entries(tmp_path):
    built = assert_same_build(
        lambda out: make_corpus.make_invariant_entries(out, "cpu"),
        ref_make_corpus.make_invariant_entries, tmp_path)
    assert len(built) == FAMILIES["inv"]
    assert all(expect for _, expect in built.values())
