"""The corpus builder's ``diff_eager_store`` entry, the port's against the
reference's, both run here.  Its shrink, under the eager-store oracle
mutation, runs the plain engine about 400 times; the family's other entries
are in ``test_torch_check_corpus_diff.py``."""

import itertools

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


def test_make_corpus_writes_the_reference_eager_store_entry(tmp_path):
    built = assert_same_build(
        lambda out: [make_corpus.make_diff_entry(out, "eager_store",
                                                 "cpu")],
        # the reference's builder writes each entry as it is drawn: the
        # first is eager_store's
        lambda out: itertools.islice(
            ref_make_corpus.make_diff_entries(out), 1),
        tmp_path)
    assert list(built) == ["diff_eager_store"]
