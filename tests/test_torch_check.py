"""The port's differential checker (``repro_torch.sim.check``) against the
JAX reference's (``repro.sim.check``), on the CPU with the plain engine.

The generators draw the same scenarios array for array, the referees (the
sequential oracle, the batch oracle's C and NumPy paths) give the reference
oracle's stats bit for bit, and the port's runner diffs the plain engine
(``mode="torch"``) against them with the reference's invariant catalog:
clean on a correct engine, failing under each oracle mutation, shrinking a
witness as the reference's shrinker does.  The kernel's lane
(``mode="cuda"``) runs in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sim.check import generate as ref_generate  # noqa: E402
from repro.sim.check import oracle as ref_oracle  # noqa: E402
from repro.sim.check import runner as ref_runner  # noqa: E402
from repro.sim.check.batch_oracle import \
    run_batch_oracle as ref_batch_oracle  # noqa: E402
from repro.sim import engine as ref_engine  # noqa: E402
from repro_torch.sim import engine  # noqa: E402
from repro_torch.sim import check  # noqa: E402
from repro_torch.sim.check import (_fastcase, check_case,  # noqa: E402
                                   failure_classes, fuzz, generate_batch,
                                   load_scenario, run_batch_oracle,
                                   run_engine_batch, run_oracle,
                                   save_scenario)
from repro_torch.sim.check import oracle  # noqa: E402
from repro_torch.sim.check.runner import (STAT_KEYS,  # noqa: E402
                                          stamp_cuda_state,
                                          stamp_torch_chunk)

ARRAYS = ("program", "init_pc", "init_regs", "init_mem", "costs")
SCALARS = ("kind", "lock", "n_active", "wa_base", "wa_size", "horizon",
           "max_events", "seed", "n_threads", "mem_words", "n_locks")
IMPLS = ["numpy"] + (["c"] if _fastcase.HAVE_FAST else [])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain engine's tensors are small: one intra-op thread per test
    worker is faster than many contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_scenario(port, ref, label):
    for k in ARRAYS:
        a, b = np.asarray(getattr(port, k)), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), (label, k)
    for k in SCALARS:
        assert getattr(port, k) == getattr(ref, k), (label, k)
    assert port.meta == ref.meta, label


def _pinned(batch, chunk=engine.DEFAULT_TORCH_CHUNK):
    """``batch`` with every case pinned to one chunk: one dispatch of the
    plain engine (its cost on the CPU is the longest case's steps)."""
    return [s.replace(meta={**s.meta, "torch_chunk": chunk}) for s in batch]


def _as_reference(s):
    return ref_generate.Scenario(
        **{k: getattr(s, k) for k in ARRAYS + SCALARS}, meta=s.meta)


@pytest.mark.parametrize("seed", [0, 7, 2026])
@pytest.mark.parametrize("fractions", [(0.0, 0.0), (0.3, 0.2)],
                         ids=["plain", "faults-traces"])
def test_generate_batch_matches_the_reference(seed, fractions):
    ff, tf = fractions
    port = generate_batch(40, seed, fault_fraction=ff, trace_fraction=tf)
    ref = ref_generate.generate_batch(40, seed, fault_fraction=ff,
                                      trace_fraction=tf)
    assert len(port) == len(ref) == 40
    for i, (p, r) in enumerate(zip(port, ref)):
        _assert_same_scenario(p, r, (seed, ff, i))
    if ff:
        assert any(s.meta.get("faults") for s in port)
        assert any(s.meta.get("workload") == "trace" for s in port)


def test_generated_batch_shapes_and_constants_match():
    assert (check.PAD_THREADS, check.PAD_LOCKS, check.PAD_MEM_WORDS) == (
        ref_generate.PAD_THREADS, ref_generate.PAD_LOCKS,
        ref_generate.PAD_MEM_WORDS)
    assert check.ORACLE_MUTATIONS == ref_oracle.ORACLE_MUTATIONS
    assert STAT_KEYS == ref_runner.STAT_KEYS
    assert oracle.INF == ref_oracle.INF and isinstance(oracle.INF, int)


def test_event_order_contract_is_the_engines_and_the_references():
    assert oracle.EVENT_ORDER_CONTRACT is engine.EVENT_ORDER_CONTRACT
    assert oracle.EVENT_ORDER_CONTRACT == ref_engine.EVENT_ORDER_CONTRACT


@pytest.fixture(scope="module")
def fault_batch():
    return generate_batch(24, 5, fault_fraction=0.5, trace_fraction=0.2)


def _assert_stats_equal(a, b, label):
    for k in STAT_KEYS:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (label, k)


def test_sequential_oracle_matches_the_reference(fault_batch):
    for i, s in enumerate(fault_batch):
        kw = s.engine_kwargs()
        port_trace, ref_trace = oracle.Trace(), ref_oracle.Trace()
        port = run_oracle(s.program, trace=port_trace, **kw)
        kw["faults"] = s.meta.get("faults")
        ref = ref_oracle.run_oracle(s.program, trace=ref_trace, **kw)
        _assert_stats_equal(port, ref, i)
        assert port_trace.acquires == ref_trace.acquires, i
        assert port_trace.exit_reason == ref_trace.exit_reason, i
        assert port_trace.faults_applied == ref_trace.faults_applied, i


@pytest.mark.parametrize("impl", IMPLS)
def test_batch_oracle_matches_the_reference(fault_batch, impl):
    port = run_batch_oracle(fault_batch, impl=impl)
    ref = ref_batch_oracle([_as_reference(s) for s in fault_batch],
                           impl=impl)
    for i, (p, r) in enumerate(zip(port.stats, ref.stats)):
        _assert_stats_equal(p, r, (impl, i))
    assert [t.acquires for t in port.traces] == \
        [t.acquires for t in ref.traces]


def test_the_c_referee_is_built_in_the_build_directory():
    """``cc`` is present here, so the batch oracle's C path is the referee,
    and its library lives under the port's build directory."""
    from repro_torch import _build
    assert _fastcase.HAVE_FAST
    assert check.oracle_impl(True) == "c"
    assert check.oracle_impl(False) == "sequential"
    assert list((_build.build_dir() / "fastcase").glob("fastcase_*.so"))


def test_the_numpy_referee_only_stands_in_for_a_missing_compiler(
        tmp_path, monkeypatch):
    """No C compiler on the host: the batch oracle takes its NumPy path.
    A compiler that fails on the source raises instead of falling back."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_fastcase, "_lib", [])
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    assert not _fastcase.HAVE_FAST
    assert check.oracle_impl(True) == "numpy"
    monkeypatch.setattr(_fastcase, "_lib", [])
    monkeypatch.setenv("CC", "false")
    with pytest.raises(subprocess.CalledProcessError):
        _fastcase.LIB


@pytest.fixture(scope="module")
def engine_outs(fault_batch):
    return run_engine_batch(_pinned(fault_batch), "torch", device="cpu")


def test_fuzz_torch_lane_is_clean(fault_batch):
    report = fuzz(_pinned(fault_batch), modes=("torch",), device="cpu",
                  batch_oracle=True)
    assert report.ok, report.summary()
    assert report.total_events > 0
    assert report.oracle_impl == check.oracle_impl(True)
    assert report.placements == {"torch:16": len(fault_batch)}


@pytest.mark.parametrize("mutation", sorted(check.ORACLE_MUTATIONS))
def test_each_oracle_mutation_is_caught(fault_batch, engine_outs, mutation):
    """What ``fuzz`` does with ``oracle_mutate``: the mutated referee
    against the engine's unchanged outputs must report differentials."""
    bres = run_batch_oracle(fault_batch, mutate=(mutation,))
    failing = [i for i, s in enumerate(fault_batch)
               if "differential" in failure_classes(check_case(
                   s, bres.stats[i], bres.traces[i],
                   {"torch": engine_outs[i]}))]
    assert failing, f"{mutation} was not caught"
    clean = run_batch_oracle(fault_batch)
    assert not any(check_case(s, clean.stats[i], clean.traces[i],
                              {"torch": engine_outs[i]})
                   for i, s in enumerate(fault_batch))


def test_the_reference_stall_is_told_from_every_other_failure():
    """Seed 1's case 2574 of a 16,384-case batch is the reference's known
    ``twa-staged`` stall (ROADMAP.md §3): the reference's checker and the
    port's, the plain engine included, report the same ``recovery`` problem
    and no differential, and ``reference_stall`` accepts it.  The same
    problems with a differential, on another lock or without the fault
    schedule are not accepted."""
    s = generate_batch(16384, 1, fault_fraction=0.25,
                       trace_fraction=0.1)[2574]
    problems = check.case_problems(_pinned([s])[0], modes=("torch",),
                                   device="cpu")
    assert failure_classes(problems) == {"recovery"}, problems
    assert ref_runner.case_problems(_as_reference(s), modes=()) == problems
    assert check.reference_stall(s, problems)
    diff = "differential[cuda]: events: oracle=1 engine=2"
    assert not check.reference_stall(s, problems + [diff])
    assert not check.reference_stall(s.replace(lock="twa"), problems)
    assert not check.reference_stall(
        s.replace(meta={**s.meta, "faults": None}), problems)


def test_placement_draws_are_deterministic_and_cover_the_pools():
    chunks = check.torch_chunks(32, seed=11)
    assert chunks == check.torch_chunks(32, seed=11)
    assert chunks != check.torch_chunks(32, seed=12)
    assert set(chunks) == set(check.TORCH_CHUNK_POOL)
    assert 1 in chunks
    states = check.cuda_states(32, seed=11)
    assert states == check.cuda_states(32, seed=11)
    assert set(states) == set(check.CUDA_STATE_POOL) == {"smem", "global"}


def test_torch_chunk_is_pinned_and_replays(tmp_path):
    """A chunk-dependent failure must replay from its own artifact: the
    stamp survives a re-stamp under another seed and the corpus
    round-trip, and a replay runs at the pinned chunk."""
    batch = sorted(generate_batch(30, 3), key=lambda s: s.horizon)[:6]
    stamped = stamp_cuda_state(stamp_torch_chunk(batch, 3), 3)
    pins = [s.meta["torch_chunk"] for s in stamped]
    assert len(set(pins)) >= 2
    again = stamp_torch_chunk(stamped, 99)
    assert [s.meta["torch_chunk"] for s in again] == pins
    path = tmp_path / "pinned.npz"
    save_scenario(path, stamped[0])
    loaded = load_scenario(path)
    assert loaded.meta["torch_chunk"] == pins[0]
    assert loaded.meta["cuda_state"] == stamped[0].meta["cuda_state"]
    seen = []
    real = engine.run_cells

    def spy(*args, chunk=None, **kw):
        seen.append(chunk)
        return real(*args, chunk=chunk, **kw)

    engine.run_cells = spy
    try:
        grouped = run_engine_batch(stamped, "torch", device="cpu")
        alone = run_engine_batch([loaded], "torch", device="cpu")[0]
    finally:
        engine.run_cells = real
    assert sorted(seen[:-1]) == sorted(set(pins)) and seen[-1] == pins[0]
    _assert_stats_equal(alone, grouped[0], "replay")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_scenarios_saved_by_either_package_load_in_the_other(tmp_path,
                                                             writer):
    batch = generate_batch(6, 9, fault_fraction=1.0)
    batch = stamp_torch_chunk(batch, 1)
    for i, s in enumerate(batch):
        path = tmp_path / f"{i}.npz"
        if writer == "port":
            save_scenario(path, s, note="port")
            back = ref_runner.load_scenario(path)
        else:
            ref_runner.save_scenario(path, _as_reference(s), note="ref")
            back = load_scenario(path)
        _assert_same_scenario(back, s, i)
    # the reference's own placement pins ride along through a re-save
    ref_pinned = ref_runner.stamp_pallas_chunk(
        ref_runner.stamp_sched_geometry([_as_reference(batch[0])], 4), 4)[0]
    path = tmp_path / "ref_pins.npz"
    ref_runner.save_scenario(path, ref_pinned)
    save_scenario(tmp_path / "resaved.npz", load_scenario(path))
    back = ref_runner.load_scenario(tmp_path / "resaved.npz")
    assert back.meta["sched_geometry"] == ref_pinned.meta["sched_geometry"]
    assert back.meta["pallas_chunk"] == ref_pinned.meta["pallas_chunk"]


def test_no_device_means_the_card():
    """The checker's engines run on ``cuda`` unless asked for the CPU, and
    the kernel's lane never runs the plain engine."""
    batch = _pinned(generate_batch(2, 0))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        fuzz(batch, modes=("cuda",), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fuzz(batch, modes=("torch",))
        from repro_torch.sim.check.__main__ import main
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--cases", "2"])
    with pytest.raises(ValueError, match="mode must be one of"):
        run_engine_batch(batch, "map", device="cpu")
