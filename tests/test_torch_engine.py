"""The port's plain PyTorch engine against the JAX reference, on the CPU.

Every comparison is exact equality (bit-identical int32 stats; the derived
float columns of the sweep rows equal as numbers, NaN matching NaN):

* the 14 ``tests/corpus`` entries, read by ``repro_torch.sim.corpus`` and
  run by the port, against the reference oracle (``run_oracle_case``) —
  they include the near-INT32_MAX wrap pins and four fault pins;
* a fresh mixed fuzz batch with fault schedules, and a batch of random
  programs with out-of-range opcodes, registers, addresses and fault
  targets, against the reference engine (``mode="map"``);
* pins of the semantics torch does not share with JAX: the argmin's tie
  rule, gather/scatter index rules, uint32 and int32 wrap-around.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sim import engine as ref_engine
from repro.sim.check.generate import generate_batch
from repro.sim.check.runner import (STAT_KEYS, load_scenario as ref_load,
                                    run_engine_batch, run_oracle_case)
from repro_torch.sim import engine, isa
from repro_torch.sim.corpus import load_scenario, scenario_sweep_args
from repro_torch.sim.programs import Layout

CORPUS = sorted(Path(__file__).parent.joinpath("corpus").glob("*.npz"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain engine's tensors are small: one intra-op thread per test
    worker is faster than many contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_stats_equal(port: dict, ref: dict, label: str):
    assert set(engine.STAT_KEYS) == set(STAT_KEYS)
    for k in STAT_KEYS:
        a, b = np.asarray(port[k]), np.asarray(ref[k])
        assert a.shape == b.shape, (label, k, a.shape, b.shape)
        assert np.array_equal(a, b), (label, k)


def test_corpus_matches_the_reference_oracle():
    assert len(CORPUS) == 14
    scenarios = [load_scenario(p) for p in CORPUS]
    programs, kw = scenario_sweep_args(scenarios)
    out = engine.run_sweep(programs, **kw, device="cpu")
    assert out["mode"] == "torch"
    for i, path in enumerate(CORPUS):
        ref, _ = run_oracle_case(ref_load(path))
        _assert_stats_equal({k: out[k][i] for k in STAT_KEYS}, ref,
                            path.name)


def test_fault_batch_matches_the_reference_engine():
    batch = generate_batch(16, seed=5, fault_fraction=0.5)
    assert any(s.meta.get("faults") for s in batch)
    ref = run_engine_batch(batch, "map")
    port = load_batch_as_port(batch)
    for i, (p, r) in enumerate(zip(port, ref)):
        _assert_stats_equal(p, r, f"case {i}")


def load_batch_as_port(batch) -> list[dict]:
    """Run reference fuzz scenarios through the port's engine (their fields
    are plain arrays and ints, so the port's corpus packer takes them)."""
    from repro_torch.sim.corpus import Scenario
    scenarios = [Scenario(
        kind=s.kind, lock=s.lock, program=s.program, init_pc=s.init_pc,
        init_regs=s.init_regs, init_mem=s.init_mem, costs=s.costs,
        n_active=s.n_active, wa_base=s.wa_base, wa_size=s.wa_size,
        horizon=s.horizon, max_events=s.max_events, seed=s.seed,
        n_threads=s.n_threads, mem_words=s.mem_words, n_locks=s.n_locks,
        meta=s.meta) for s in batch]
    programs, kw = scenario_sweep_args(scenarios)
    out = engine.run_sweep(programs, **kw, device="cpu", chunk=7)
    return [{k: out[k][i] for k in STAT_KEYS} for i in range(len(batch))]


def test_out_of_range_programs_match_the_reference_engine():
    """Random programs: opcodes outside the ISA, register fields outside
    0..15, addresses and branch targets out of range, faults aimed at
    threads that do not exist — JAX's clamp/drop index rules everywhere."""
    rng = np.random.default_rng(2024)
    n_cells, n_threads, mem_words = 12, 8, 64
    programs = np.zeros((n_cells, 256, 5), np.int32)
    programs[:, :, 0] = rng.integers(-3, isa.N_OPS + 4, (n_cells, 256))
    programs[:, :, 1:4] = rng.integers(-20, 20, (n_cells, 256, 3))
    programs[:, :, 4] = rng.choice(
        [0, 1, 2, 5, 17, 63, 64, 100, 255, 256, 300, -1, -5, -70, -300,
         2**31 - 1, -2**31, 12345], (n_cells, 256))
    kw = dict(
        mem_words=mem_words, n_locks=2,
        init_pc=rng.integers(-3, 20, (n_cells, n_threads)),
        init_regs=rng.choice([0, 1, -1, 5, 63, 64, -65, 2**31 - 1, -2**31,
                              7, 16, -17], (n_cells, n_threads, 16)),
        n_active=rng.integers(1, n_threads + 1, n_cells),
        seeds=rng.integers(0, 2**32, n_cells, dtype=np.uint64)
        .astype(np.uint32),
        wa_base=rng.integers(0, mem_words, n_cells), wa_size=8,
        horizon=3_000, max_events=600,
        costs=rng.integers(1, 40, (n_cells, 9)),
        init_mem=rng.choice([0, 1, -1, 2**31 - 1, -2**31, 3, 70],
                            (n_cells, mem_words)),
        faults=(rng.choice([0, 1, 2, 3, 5], (n_cells, 6)),
                rng.integers(0, 60, (n_cells, 6)),
                rng.integers(-10, 10, (n_cells, 6)),
                rng.integers(-50, 600, (n_cells, 6))))
    kw = {k: (tuple(np.asarray(a, np.int32) for a in v) if k == "faults"
              else v) for k, v in kw.items()}
    ref = ref_engine.run_sweep(programs, mode="map", **kw)
    port = engine.run_sweep(programs, device="cpu", **kw)
    _assert_stats_equal(port, ref, "random programs")


# ---------------------------------------------------------------------------
# Pins: semantics torch does not share with JAX
# ---------------------------------------------------------------------------
def test_index_rules_match_jax():
    idx = np.array([-100, -5, -4, -3, -1, 0, 2, 3, 4, 7, 100])
    x = jnp.arange(4)
    jax_gather = np.asarray([int(x[int(i)]) for i in idx])
    assert engine.gather_index(torch.as_tensor(idx), 4).tolist() == \
        jax_gather.tolist()
    clamped, ok = engine.scatter_index(torch.as_tensor(idx), 4)
    for i, c, o in zip(idx, clamped.tolist(), ok.tolist()):
        written = np.asarray(jnp.zeros(4, jnp.int32).at[int(i)].set(1))
        if o:
            assert written.tolist() == np.eye(4, dtype=int)[c].tolist(), i
        else:
            assert not written.any(), i


def test_int32_wrap_popcount_and_prng_match_numpy():
    vals = np.array([0, 1, -1, 2**31 - 1, -2**31, 2**31, 2**32 + 5,
                     -2**31 - 1, 3 * 2**31, -(2**40) + 7], np.int64)
    want = vals.astype(np.uint64).astype(np.uint32).view(np.int32)
    assert engine.wrap32(torch.as_tensor(vals)).tolist() == want.tolist()
    a, b = np.int32(2**31 - 5), np.int32(9)
    with np.errstate(over="ignore"):
        assert int(engine.wrap32(torch.tensor(int(a)) + int(b))) == int(a + b)
        assert int(engine.wrap32(torch.tensor(int(a)) * 127)) == \
            int(a * np.int32(127))
    words = np.random.default_rng(0).integers(0, 2**32, 500,
                                              dtype=np.uint64)
    words[:3] = [0, 2**32 - 1, 2**31]
    pop = [bin(int(w)).count("1") for w in words]
    assert engine.popcount32(torch.as_tensor(words.astype(np.int64))
                             ).tolist() == pop
    # the PRNG: uint32 LCG held in int64 against numpy's uint32
    sd_np = np.uint32(0xDEADBEEF)
    sd_t = torch.tensor(0xDEADBEEF, dtype=torch.int64)
    for _ in range(50):
        with np.errstate(over="ignore"):
            sd_np = sd_np * np.uint32(1664525) + np.uint32(1013904223)
        sd_t = (sd_t * 1664525 + 1013904223) & engine.MASK32
        assert int(sd_t) == int(sd_np)


def _one_step_state(next_time, pend_time, pend_addr):
    """A one-cell packed state of NOP-running threads, and its step."""
    n = len(next_time)
    layout = Layout(n_threads=n, n_locks=1)
    prog = np.zeros((256, 5), np.int64)
    prog[:, 0] = isa.NOP
    c = engine.SimConsts(
        program=torch.as_tensor(prog)[None],
        costs=torch.as_tensor(np.arange(1, 10, dtype=np.int64))[None],
        wa_base=torch.tensor([0]), wa_mask=torch.tensor([7]),
        wa_size=torch.tensor([8]), horizon=torch.tensor([10_000]),
        max_events=torch.tensor([100]))
    s = engine._initial_state(
        n, layout.mem_words, 1, torch.zeros((1, n), dtype=torch.int64),
        torch.zeros((1, n, isa.N_REGS), dtype=torch.int64),
        torch.zeros((1, layout.mem_words), dtype=torch.int64),
        torch.tensor([n]), torch.tensor([1]))
    s.th[0, :, engine.TH_NT] = torch.tensor(next_time)
    s.th[0, :, engine.TH_PT] = torch.tensor(pend_time)
    s.th[0, :, engine.TH_PA] = torch.tensor(pend_addr)
    aux = engine._aux(1, n, torch.device("cpu"))
    return s, lambda: engine._step(c, s, aux)


def test_event_selection_tie_rules():
    # a commit and a thread op at the same time: the commit goes first
    s, step = _one_step_state([7, 5, 5], [9, 9, 5], [-1, -1, 32])
    step()
    assert s.th[0, :, engine.TH_PA].tolist() == [-1, -1, -1]  # 2's commit
    assert s.th[0, :, engine.TH_PC].tolist() == [0, 0, 0]     # no op ran
    assert int(s.mem[0, 32]) == 0
    assert int(s.cell[0, engine.CELL_EV]) == 1
    # then the two thread ops tied at 5: the lowest thread index first
    step()
    assert s.th[0, :, engine.TH_PC].tolist() == [0, 1, 0]
    step()
    assert s.th[0, :, engine.TH_PC].tolist() == [0, 1, 1]
    # a first minimum in a long vector of ties (argmin's order is not relied
    # on: the step picks the lowest index explicitly)
    s, step = _one_step_state([3] * 40, [3] * 40, [-1] * 40)
    step()
    assert s.th[0, :, engine.TH_PC].tolist() == [1] + [0] * 39
