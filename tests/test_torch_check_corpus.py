"""The fuzz corpus through the port's checker: the committed entries under
``tests/corpus`` replay to their pinned ``expect_classes``, and the port's
corpus builder (``repro_torch.sim.check.make_corpus``) writes what the
reference's builder (``repro.sim.check.make_corpus``) writes, run in the
same test on the same seeds: every array of every entry and its meta.

Here the wrap and fault families; the shrunk families, whose shrinks run
the plain engine hundreds of times, each in a file of its own
(``test_torch_check_corpus_eager.py``, ``_diff.py``, ``_inv.py``).  On the
card the kernel's build of the whole corpus must equal the plain engine's.

The committed entries predate the generators' latency instrumentation (a
composed program now opens with ``TSTART``), so neither builder rewrites
them byte for byte today; each rebuilt entry has a committed one of its
name with the same ``expect_classes``.
"""

import hashlib
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.sim.check import (failure_classes, load_scenario,  # noqa: E402,E501
                                   make_corpus, replay_corpus)

CORPUS_DIR = Path(__file__).parent / "corpus"
CORPUS = sorted(CORPUS_DIR.glob("*.npz"))
# entries of each family, by name prefix
FAMILIES = {"diff": 3, "inv": 5, "wrap": 2, "fault": 4}


def entry_digest(path) -> str:
    """A digest of every array of a ``.npz`` entry, its JSON meta included
    (name, dtype, shape and bytes, in name order)."""
    h = hashlib.sha256()
    with np.load(path) as z:
        for k in sorted(z.files):
            a = z[k]
            h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def built_entries(out_dir) -> dict:
    """name -> (digest, expect_classes) of every entry in ``out_dir``."""
    return {p.stem: (entry_digest(p),
                     load_scenario(p).meta["expect_classes"])
            for p in sorted(Path(out_dir).glob("*.npz"))}


def assert_same_build(port_build, ref_build, tmp_path) -> dict:
    """Run the port's builder and the reference's into two directories of
    ``tmp_path``.  The port's writes nothing but its entries, each equal to
    the reference's entry of that name, and the committed entry of that
    name pins the same ``expect_classes``."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    names = [name for name, _ in port_build(port_dir)]
    ref_names = [name for name, _ in ref_build(str(ref_dir))]
    assert set(names) <= set(ref_names), (names, ref_names)
    assert sorted(p.name for p in port_dir.iterdir()) == \
        sorted(f"{n}.npz" for n in names)
    port, ref = built_entries(port_dir), built_entries(ref_dir)
    assert port == {n: ref[n] for n in names}
    for name, (_, expect) in port.items():
        committed = load_scenario(CORPUS_DIR / f"{name}.npz")
        assert sorted(committed.meta["expect_classes"]) == expect, name
    return port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain engine's tensors are small: one intra-op thread per test
    worker is faster than many contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def replayed():
    """The whole corpus in one batched replay (one dispatch per shape
    group) through the plain engine, against the batch oracle."""
    return dict(zip(CORPUS, replay_corpus(CORPUS, modes=("torch",),
                                          device="cpu")))


def test_corpus_is_the_fourteen_pinned_entries():
    assert Counter(p.stem.split("_")[0] for p in CORPUS) == FAMILIES
    for p in CORPUS:
        expect = load_scenario(p).meta.get("expect_classes", [])
        assert bool(expect) == p.stem.startswith("inv_"), p.stem


@pytest.mark.parametrize("path", CORPUS, ids=[p.stem for p in CORPUS])
def test_corpus_entry_replays_to_its_expect_classes(replayed, path):
    expect = set(load_scenario(path).meta.get("expect_classes", []))
    problems = replayed[path]
    assert failure_classes(problems) == expect, problems[:4]


@pytest.mark.parametrize("family", ["wrap", "fault"])
def test_make_corpus_writes_the_reference_entries(tmp_path, family):
    # imported here: the card's host, which runs this file's cuda test,
    # has no JAX
    from repro.sim.check import make_corpus as ref_make_corpus
    port = getattr(make_corpus, f"make_{family}_entries")
    built = assert_same_build(
        lambda out: port(out, "cpu"),
        getattr(ref_make_corpus, f"make_{family}_entries"), tmp_path)
    assert len(built) == FAMILIES[family]


@pytest.mark.cuda
def test_make_corpus_on_the_card_writes_the_plain_engines_entries(tmp_path):
    """The whole corpus built through the kernel equals the plain engine's
    build, which the CPU tests hold to the reference's family by family."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    make_corpus.main(str(tmp_path / "cuda"), "cuda")
    make_corpus.main(str(tmp_path / "cpu"), "cpu")
    card = built_entries(tmp_path / "cuda")
    assert len(card) == sum(FAMILIES.values())
    assert card == built_entries(tmp_path / "cpu")


def test_replay_cli_reports_every_entry_ok():
    """``python -m repro_torch.sim.check --replay tests/corpus`` on the CPU
    (the card runs it with ``--modes cuda``)."""
    from repro_torch.sim.check.__main__ import main
    rc = main(["--device", "cpu", "--replay", str(CORPUS[0].parent),
               "--batch-oracle"])
    assert rc == 0
