"""The port's sweep front end (``repro_torch.sim.workloads``, ``run_sim``,
``debug_states`` and the fig3 benchmark) against the JAX reference, on the
CPU with the plain engine.

Exact equality throughout: the int32 stats bit for bit, the derived float
columns (throughput, handover, ``lat_p50/p99/p999``) equal as numbers, NaN
matching NaN, and the fig3 CSV rows equal as text.
"""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sim import engine as ref_engine  # noqa: E402
from repro.sim import workloads as ref_workloads  # noqa: E402
from repro_torch.bench import fig3_mutexbench  # noqa: E402
from repro_torch.sim import SIM_LOCKS, engine, workloads  # noqa: E402
from repro_torch.sim.programs import (Layout, build_mutexbench,  # noqa: E402
                                      init_state)

STAT_KEYS = engine.STAT_KEYS

# fig3-shaped check: every lock at 1, 8 and 64 threads (twa-timo's generator
# stops at 32).  The horizon is chosen by measurement: a 64-thread cell
# executes about five events per cycle, the plain engine pays one batched
# step (about a millisecond) per event on the CPU, and 1,000 cycles keeps
# this check near ten seconds.
FIG3_HORIZON = 1_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain engine's tensors are small: one intra-op thread per test
    worker is faster than many contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_stats_equal(port: dict, ref: dict, label: str):
    for k in STAT_KEYS:
        a, b = np.asarray(port[k]), np.asarray(ref[k])
        assert a.shape == b.shape, (label, k, a.shape, b.shape)
        assert np.array_equal(a, b), (label, k)


def _rows_equal(port_rows, ref_rows):
    assert len(port_rows) == len(ref_rows)
    for p, r in zip(port_rows, ref_rows):
        for k, v in r.items():
            if k in ("mode", "pad_stats", "layout", "fault_schedule",
                     "costs"):
                continue
            if isinstance(v, float) and np.isnan(v):
                assert np.isnan(p[k]), (r["lock"], r["n_threads"], k)
            else:
                assert np.array_equal(np.asarray(p[k]), np.asarray(v)), \
                    (r["lock"], r["n_threads"], k, p[k], v)
        assert p["layout"].mem_words == r["layout"].mem_words


def test_fig3_shaped_sweep_matches_the_reference():
    kw = dict(seeds=1, horizon=FIG3_HORIZON, collect_latency=True)
    others = tuple(lk for lk in SIM_LOCKS if lk != "twa-timo")
    specs = [(dict(locks=others, threads=(1, 8, 64)), "others"),
             (dict(locks="twa-timo", threads=(1, 8, 32)), "timo")]
    port = workloads.run_sweeps(
        [workloads.SweepSpec(**s, **kw) for s, _ in specs], device="cpu")
    for (s, _), rows in zip(specs, port):
        ref = ref_workloads.run_sweep(ref_workloads.SweepSpec(**s, **kw),
                                      mode="map")
        _rows_equal(rows, ref)
        assert all(np.isfinite(r["lat_p50"]) for r in rows if r["n_threads"]
                   > 1)


def test_run_sim_debug_states_and_helpers_match():
    layout = Layout(n_threads=5, n_locks=1)
    pc, regs = init_state(layout)
    prog = build_mutexbench("twa", layout, collect_latency=True)
    kw = dict(n_threads=5, mem_words=layout.mem_words, n_locks=1,
              init_pc=pc, init_regs=regs, wa_base=layout.wa_base,
              wa_size=layout.wa_size, horizon=1_500, seed=9)
    ref = ref_engine.run_sim(prog, **kw)
    port = engine.run_sim(prog, **kw, device="cpu")
    for k in ("acquisitions", "waited_acquisitions", "handover_sum",
              "handover_count", "events", "sleeping", "mem", "lat_hist",
              "throughput", "avg_handover"):
        assert np.array_equal(np.asarray(port[k]), np.asarray(ref[k])), k
    states = list(engine.debug_states(prog, **kw, device="cpu"))
    assert [int(st.events) for st in states] == \
        list(range(1, int(port["events"]) + 1))
    assert np.array_equal(states[-1].mem, port["mem"])
    assert np.array_equal(states[-1].acq, port["acquisitions"])
    # event by event, every state field, with a fault schedule attached
    faults = (np.array([1, 2, 3, 1], np.int32), np.array([20, 45, 70, 100],
                                                         np.int32),
              np.array([2, 0, 4, 1], np.int32), np.array([300, 0, 0, 64],
                                                         np.int32))
    ref_states = list(ref_engine.debug_states(prog, **kw, faults=faults))
    port_states = list(engine.debug_states(prog, **kw, faults=faults,
                                           device="cpu"))
    assert len(port_states) == len(ref_states) > 100  # every fault lands
    for i, (p_st, r_st) in enumerate(zip(port_states, ref_states)):
        for field in r_st._fields:
            assert np.array_equal(np.asarray(getattr(p_st, field)),
                                  np.asarray(getattr(r_st, field))), \
                (i, field)
    hist = np.asarray(port["lat_hist"])
    assert workloads.hist_percentile(hist, 0.99) == \
        ref_workloads.hist_percentile(hist, 0.99)
    cells = [("ticket", 3, 900), ("mcs", 6, 400), ("twa-sem", 2, 1200)]
    p_prog, p_kw = workloads.pack_engine_cells(cells, seeds=4)
    r_prog, r_kw = ref_workloads.pack_engine_cells(cells, seeds=4)
    assert np.array_equal(p_prog, r_prog)
    assert p_kw.keys() == r_kw.keys()
    for k in p_kw:
        assert np.array_equal(np.asarray(p_kw[k]), np.asarray(r_kw[k])), k
    port_raw = engine.run_sweep(p_prog, **p_kw, device="cpu")
    ref_raw = ref_engine.run_sweep(r_prog, **r_kw, mode="map")
    _assert_stats_equal(port_raw, ref_raw, "pack_engine_cells")
    assert port_raw["pad_stats"] == ref_raw["pad_stats"]
    assert workloads.fig1_invalidation_diameter(
        reader_counts=(0, 3), horizon=1_500, device="cpu") == \
        ref_workloads.fig1_invalidation_diameter(reader_counts=(0, 3),
                                                 horizon=1_500)


def test_fig3_benchmark_rows_match_the_reference():
    """The port's fig3 script prints the reference script's rows (over the
    thread counts twa-timo's generator accepts)."""
    locks, threads, horizon = ("ticket", "twa", "mcs", "twa-timo"), (1, 64), 300
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fig3_mutexbench.run(locks, threads, runs=1, horizon=horizon,
                            device="cpu")
    rows = out.getvalue().splitlines()
    assert "fig3/twa-timo/threads=64" not in out.getvalue()
    want = []
    ref = {}
    for lock in locks:
        ts = (1,) if lock == "twa-timo" else threads
        spec = ref_workloads.SweepSpec(locks=lock, threads=ts, seeds=1,
                                       cs_work=4, ncs_max=200,
                                       collect_latency=True, horizon=horizon)
        for r in ref_workloads.run_sweep(spec, mode="map"):
            ref[lock, r["n_threads"]] = r
            want.append(f"fig3/{lock}/threads={r['n_threads']},"
                        f"{r['throughput']:.6f},acq_per_cycle")
            for col in ("lat_p50", "lat_p99", "lat_p999"):
                want.append(f"fig3/{lock}/threads={r['n_threads']}/{col},"
                            f"{float(r[col]):.0f},cycles")
    tw, tk, mc = (ref[lk, 64]["throughput"] for lk in ("twa", "ticket",
                                                       "mcs"))
    want += [f"fig3/twa_over_ticket@64,{tw / tk:.3f},paper: >>1",
             f"fig3/twa_over_mcs@64,{tw / mc:.3f},paper: >=1"]
    assert rows == want
