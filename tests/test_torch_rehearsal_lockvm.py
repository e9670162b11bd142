"""The lockVM kernel's device code, run on the host, against the plain
engine.

``repro_torch.rehearse`` compiles ``csrc/lockvm_step.cuh`` with ``g++`` and
the generated constants header the ``nvcc`` build uses, and runs the warp's
32 lanes as host threads (``csrc/rehearse/warp_emu.h``: a barrier per warp
primitive).  So the kernel's event loop is held bit for bit to the plain
PyTorch engine here, without a card: on the 14 ``tests/corpus`` entries, a
fresh fuzz batch with fault schedules from the reference's generator,
random programs with out-of-range opcodes, registers and addresses, fig3
cells, and cells of 40 and 130 threads, with each simulated thread's rows
in registers (1, 2 or 4 a lane) and in memory.  The selective scan's
rehearsal is in ``test_torch_rehearsal_scan.py``.

Each test decides for itself whether ``g++`` is there, and skips if not.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sim.check.generate import generate_batch
from repro_torch import rehearse
from repro_torch.sim import SIM_LOCKS, SweepSpec, engine, isa
from repro_torch.sim import sweep_engine_args
from repro_torch.sim.corpus import (Scenario, load_scenario,
                                    scenario_sweep_args)

CORPUS = sorted(Path(__file__).parent.joinpath("corpus").glob("*.npz"))


@pytest.fixture
def gxx():
    if rehearse.gxx_path() is None:
        pytest.skip("no g++: the rehearsal programs are built from source")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain engine's tensors are small: one intra-op thread per test
    worker is faster than many contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _device_code_matches_plain(args, n_locks, tpl=None):
    plain = engine.run_cells(*args, n_locks=n_locks)
    host = rehearse.lockvm_run_cells(*args, n_locks=n_locks, tpl=tpl)
    bad = [k for k in engine.OUT_KEYS if not torch.equal(host[k], plain[k])]
    assert not bad, bad
    assert int(plain["events"].sum()) > 0
    return plain


def _spec_inputs(specs):
    progs, kw, _ = sweep_engine_args(specs)
    kw.pop("live_mem_words")
    n_locks = kw.pop("n_locks")
    return engine.sweep_inputs(progs, **kw, device="cpu"), n_locks


@pytest.mark.parametrize("tpl", [None, 4, 0])
def test_lockvm_device_code_matches_plain_on_the_corpus(gxx, tpl):
    assert len(CORPUS) == 14
    progs, kw = scenario_sweep_args([load_scenario(p) for p in CORPUS])
    n_locks = kw.pop("n_locks")
    _device_code_matches_plain(engine.sweep_inputs(progs, **kw,
                                                   device="cpu"),
                               n_locks, tpl)


def test_lockvm_device_code_matches_plain_on_a_fault_batch(gxx):
    batch = generate_batch(16, seed=5, fault_fraction=0.5)
    assert any(s.meta.get("faults") for s in batch)
    scenarios = [Scenario(
        kind=s.kind, lock=s.lock, program=s.program, init_pc=s.init_pc,
        init_regs=s.init_regs, init_mem=s.init_mem, costs=s.costs,
        n_active=s.n_active, wa_base=s.wa_base, wa_size=s.wa_size,
        horizon=s.horizon, max_events=s.max_events, seed=s.seed,
        n_threads=s.n_threads, mem_words=s.mem_words, n_locks=s.n_locks,
        meta=s.meta) for s in batch]
    progs, kw = scenario_sweep_args(scenarios)
    n_locks = kw.pop("n_locks")
    args = engine.sweep_inputs(progs, **kw, device="cpu")
    assert args[-1] is not None and bool((args[-1][0] != 0).any())
    _device_code_matches_plain(args, n_locks)


@pytest.mark.parametrize("horizon", [3_000, 2**30 + 5])
def test_lockvm_device_code_on_out_of_range_programs(gxx, horizon):
    """Opcodes outside the ISA (one of them exactly N_OPS, which reaches the
    commit handler), register fields outside 0..15, addresses and branch
    targets out of range, faults aimed at threads that do not exist; and a
    horizon past INF, where threads past n_active (parked at INF) can act."""
    rng = np.random.default_rng(2024)
    n_cells, n_threads, mem_words = 12, 8, 64
    programs = np.zeros((n_cells, 256, 5), np.int32)
    programs[:, :, 0] = rng.integers(-3, isa.N_OPS + 4, (n_cells, 256))
    programs[:, :, 1:4] = rng.integers(-20, 20, (n_cells, 256, 3))
    programs[:, :, 4] = rng.choice(
        [0, 1, 2, 5, 17, 63, 64, 100, 255, 256, 300, -1, -5, -70, -300,
         2**31 - 1, -2**31, 12345], (n_cells, 256))
    assert (programs[:, :, 0] == isa.N_OPS).any()
    args = engine.sweep_inputs(
        programs, mem_words=mem_words,
        init_pc=rng.integers(-3, 20, (n_cells, n_threads)),
        init_regs=rng.choice([0, 1, -1, 5, 63, 64, -65, 2**31 - 1, -2**31,
                              7, 16, -17], (n_cells, n_threads, 16)),
        n_active=rng.integers(1, n_threads + 1, n_cells),
        seeds=rng.integers(0, 2**32, n_cells, dtype=np.uint64)
        .astype(np.uint32),
        wa_base=rng.integers(0, mem_words, n_cells), wa_size=8,
        horizon=horizon, max_events=600,
        costs=rng.integers(1, 40, (n_cells, 9)),
        init_mem=rng.choice([0, 1, -1, 2**31 - 1, -2**31, 3, 70],
                            (n_cells, mem_words)),
        faults=(rng.choice([0, 1, 2, 3, 5], (n_cells, 6)),
                rng.integers(0, 60, (n_cells, 6)),
                rng.integers(-10, 10, (n_cells, 6)),
                rng.integers(-50, 600, (n_cells, 6))),
        device="cpu")
    _device_code_matches_plain(args, 2)


def test_lockvm_device_code_threads_past_n_active_past_inf(gxx):
    """A horizon past INF: thread 0 works until just below INF, then stores,
    so its commit and its next op lie past INF, and the first event at INF
    is the (empty) commit of thread 1, which is past n_active.  A kernel
    that left threads past n_active out of the selection would run thread
    0's commit instead."""
    inf = engine.INF
    program = np.zeros((1, 8, 5), np.int32)
    program[0, 0] = (isa.WORKI, 0, 0, 0, inf - 5)
    program[0, 1] = (isa.STOREI, 0, 7, 0, 16)
    program[0, 2] = (isa.HALT, 0, 0, 0, 0)
    for n_active in (1, 3):
        args = engine.sweep_inputs(
            program, mem_words=64, init_pc=np.zeros((1, 8), np.int32),
            init_regs=np.zeros((1, 8, 16), np.int32), n_active=n_active,
            seeds=1, wa_base=0, wa_size=8, horizon=2**30, max_events=40,
            device="cpu")
        plain = _device_code_matches_plain(args, 1)
        assert int(plain["events"][0]) == 40
        assert int(plain["grant_value"][0, 16]) == 0  # the store never lands


@pytest.mark.parametrize("threads,tpl", [(40, None), (40, 4), (40, 0),
                                         (130, None)])
def test_lockvm_device_code_rows_in_registers_and_memory(gxx, threads, tpl):
    """Cells past one warp: 40 threads with rows in registers (two or four
    a lane) and in memory, with faults; 130 threads, past the registers'
    limit of 128 (rows in memory)."""
    if threads == 40:
        specs = [SweepSpec(locks=("ticket", "twa", "mcs", "twa-sem"),
                           threads=(40,), seeds=1, horizon=2_000,
                           preempt_faults=3, spurious_faults=2,
                           abort_faults=1, preempt_cost=512,
                           fault_evt_span=1_500, collect_latency=True)]
    else:
        specs = [SweepSpec(locks=("ticket", "twa"), threads=(130,), seeds=1,
                           horizon=600, collect_latency=True)]
    args, n_locks = _spec_inputs(specs)
    _device_code_matches_plain(args, n_locks, tpl)


def test_lockvm_device_code_on_fig3_cells(gxx):
    """Every lock at 1, 3 and 8 threads with faults, and 33 and 64 threads
    (two slots a lane), at short horizons."""
    specs = [SweepSpec(locks=tuple(SIM_LOCKS), threads=(1, 3, 8), seeds=2,
                       horizon=3_000, preempt_faults=2, spurious_faults=2,
                       abort_faults=1, fault_evt_span=1_500,
                       collect_latency=True),
             SweepSpec(locks=("ticket", "twa", "mcs"), threads=(33, 64),
                       seeds=1, horizon=1_500, collect_latency=True)]
    for spec in specs:
        args, n_locks = _spec_inputs([spec])
        _device_code_matches_plain(args, n_locks)
