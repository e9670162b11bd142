"""The port's NumPy-level lockVM layer against the JAX package's.

``repro_torch.sim`` keeps its own copies of the ISA, costs, program
generators, fault schedules and trace compiler.  Every array they build must
be byte-identical to the reference's (``repro.sim``) on the same inputs: the
programs, ``init_state`` and the init-mem arrays of every lock over a grid
of layouts, the probes, the trace compiler, the fault schedules.  Tolerance:
exact equality of values, dtypes and shapes.

The last test shows that ``repro_torch`` and the smoke script import
neither JAX nor anything of ``repro``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.sim import engine as ref_engine
from repro.sim import faults as ref_faults
from repro.sim import programs as ref_programs
from repro.sim import traces as ref_traces
from repro_torch.sim import engine as port_engine
from repro_torch.sim import faults as port_faults
from repro_torch.sim import isa as port_isa
from repro_torch.sim import programs as port_programs
from repro_torch.sim import traces as port_traces

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCKS = tuple(ref_programs.SIM_LOCKS)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                        a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _same_or_same_error(port_fn, ref_fn):
    """Equal arrays, or the same exception from both (a generator refuses
    some layouts, e.g. anderson with shared arrays over several locks)."""
    try:
        ref = ref_fn()
    except (AssertionError, ValueError) as e:
        with pytest.raises(type(e)) as got:
            port_fn()
        assert str(got.value) == str(e)
        return
    _same(port_fn(), ref)


def _max_threads(lock):
    return ref_programs.TIMO_RING if lock == "twa-timo" else 64


def _layout_grid(lock):
    """Threads 1-64 at defaults, then one axis at a time at 1, 8 and the
    lock's maximum thread count, then a few axes together."""
    tmax = _max_threads(lock)
    grid = [dict(n_threads=t) for t in (1, 2, 3, 5, 8, 16, 17, 31, 32, 33,
                                        48, 63, 64) if t <= tmax]
    axes = dict(wa_size=(64, 1024, 4096, 65536), long_term_threshold=(0, 1,
                                                                      2, 7),
                reader_fraction=(0, 25, 50, 100), sem_permits=(1, 4, 13),
                timo_patience=(1, 24, 100), private_arrays=(True,),
                count_collisions=(True,), n_locks=(2,))
    for t in (1, 8, tmax):
        for name, values in axes.items():
            grid += [dict(n_threads=t, **{name: v}) for v in values]
    grid += [dict(n_threads=tmax, wa_size=256, long_term_threshold=3,
                  reader_fraction=75, sem_permits=2, timo_patience=5,
                  count_collisions=True, n_locks=3, private_arrays=True)]
    return grid


@pytest.mark.parametrize("lock", LOCKS)
def test_programs_init_state_and_memory_match(lock):
    for kw in _layout_grid(lock):
        kw = {"n_locks": 1, **kw}
        ref_l, port_l = ref_programs.Layout(**kw), port_programs.Layout(**kw)
        assert (port_l.mem_words, port_l.wa_base, port_l.node_base) == \
            (ref_l.mem_words, ref_l.wa_base, ref_l.node_base)
        for bench in (dict(), dict(collect_latency=True),
                      dict(outside_work=7, cs_work=9, ncs_max=50),
                      dict(cs_rand=(2, 12), collect_latency=True)):
            _same_or_same_error(
                lambda: port_programs.build_mutexbench(lock, port_l, **bench),
                lambda: ref_programs.build_mutexbench(lock, ref_l, **bench))
        for p, r in zip(port_programs.init_state(port_l),
                        ref_programs.init_state(ref_l)):
            _same(p, r)
        assert (lock in port_programs.INIT_MEM_GEN) == \
            (lock in ref_programs.INIT_MEM_GEN)
        if lock in ref_programs.INIT_MEM_GEN:
            _same_or_same_error(
                lambda: port_programs.INIT_MEM_GEN[lock](port_l),
                lambda: ref_programs.INIT_MEM_GEN[lock](ref_l))


def test_probes_pads_and_constants_match():
    assert port_programs.SIM_LOCKS == ref_programs.SIM_LOCKS
    assert port_programs.PROG_LEN == ref_programs.PROG_LEN
    assert port_engine.EVENT_ORDER_CONTRACT == ref_engine.EVENT_ORDER_CONTRACT
    assert port_engine.INF == int(ref_engine.INF)
    assert port_engine.N_LAT_BUCKETS == ref_engine.N_LAT_BUCKETS
    _same(port_programs.build_invalidation_diameter()[0],
          ref_programs.build_invalidation_diameter()[0])
    assert port_programs.build_invalidation_diameter()[1] == \
        ref_programs.build_invalidation_diameter()[1]
    for lock in LOCKS:
        if lock in ("tkt-dual", "twa-rw"):
            continue
        for t in (1, 8, min(_max_threads(lock), 40)):
            _same(port_programs.build_occupancy_probe(
                      lock, port_programs.Layout(n_threads=t, n_locks=1)),
                  ref_programs.build_occupancy_probe(
                      lock, ref_programs.Layout(n_threads=t, n_locks=1)))
    for rf in (0, 50, 100):
        kw = dict(n_threads=16, n_locks=1, reader_fraction=rf)
        _same(port_programs.build_rw_probe(port_programs.Layout(**kw)),
              ref_programs.build_rw_probe(ref_programs.Layout(**kw)))
    rng = np.random.default_rng(3)
    prog = rng.integers(0, 30, (40, 5)).astype(np.int32)
    _same(port_programs.pad_program(prog), ref_programs.pad_program(prog))
    pc, regs = rng.integers(0, 9, 5), rng.integers(-9, 9, (5, 16))
    for p, r in zip(port_programs.pad_threads(pc, regs, 12),
                    ref_programs.pad_threads(pc, regs, 12)):
        _same(p, r)
    mem = rng.integers(-5, 5, 100).astype(np.int32)
    _same(port_programs.pad_mem(mem, 160), ref_programs.pad_mem(mem, 160))
    layout = dict(n_threads=8, n_locks=1, count_collisions=True)
    mem = rng.integers(0, 50, ref_programs.Layout(**layout).mem_words)
    for p, r in zip(port_programs.read_collision_counters(
            mem, port_programs.Layout(**layout)),
            ref_programs.read_collision_counters(
                mem, ref_programs.Layout(**layout))):
        _same(p, r)
    assert port_isa.OP_NAMES == __import__("repro.sim.isa").sim.isa.OP_NAMES


def test_trace_compiler_matches():
    rng = np.random.default_rng(11)
    tw = dict(name="t", n_threads=6,
              cs_table=tuple(int(x) for x in rng.integers(1, 30, 32)),
              out_table=tuple(int(x) for x in rng.integers(0, 40, 32)),
              arrival_table=tuple(int(x) for x in rng.integers(0, 500, 6)),
              reader_fraction=30, cs_work_rep=5, outside_work_rep=9)
    ref_tw, port_tw = ref_traces.TraceWorkload(**tw), \
        port_traces.TraceWorkload(**tw)
    for lock in LOCKS:
        ref_l = ref_traces.trace_layout_for(
            ref_tw, ref_programs.Layout(n_threads=6, n_locks=1))
        port_l = port_traces.trace_layout_for(
            port_tw, port_programs.Layout(n_threads=6, n_locks=1))
        _same(port_traces.build_trace_bench(lock, port_l, port_tw,
                                            collect_latency=True),
              ref_traces.build_trace_bench(lock, ref_l, ref_tw,
                                           collect_latency=True))
        _same(port_traces.trace_init_mem(lock, port_l, port_tw),
              ref_traces.trace_init_mem(lock, ref_l, ref_tw))


def test_fault_schedules_match():
    ref_scheds, port_scheds = [], []
    for seed in range(12):
        kw = dict(n_active=1 + seed % 8, max_events=5_000,
                  n_preempt=seed % 4, n_spurious=(seed * 7) % 3,
                  n_abort=seed % 2, k_range=(8, 64 + seed),
                  evt_span=None if seed % 3 else 700)
        r = ref_faults.draw_schedule(np.random.default_rng(seed), **kw)
        p = port_faults.draw_schedule(np.random.default_rng(seed), **kw)
        for f in ("kind", "evt", "tid", "arg"):
            _same(getattr(p, f), getattr(r, f))
        assert p.to_lists() == r.to_lists()
        ref_scheds.append(r)
        port_scheds.append(p)
    for p, r in zip(port_faults.stack_schedules(port_scheds),
                    ref_faults.stack_schedules(ref_scheds)):
        _same(p, r)
    for p, r in zip(port_faults.stack_schedules(port_scheds, 9),
                    ref_faults.stack_schedules(ref_scheds, 9)):
        _same(p, r)


def test_port_imports_neither_jax_nor_the_reference():
    """``repro_torch``, its subpackages (the lockVM, core, configs, kernels,
    models, serve and the serve launcher) and everything ``chip_smoke``
    imports load without JAX or any ``repro`` module."""
    code = textwrap.dedent("""
        import importlib.util, sys
        sys.path.insert(0, "src")
        import repro_torch, repro_torch.sim, repro_torch._build
        import repro_torch.sim.engine_cuda, repro_torch.sim.corpus
        import repro_torch.bench.fig3_mutexbench
        import repro_torch.core, repro_torch.configs, repro_torch.kernels
        import repro_torch.kernels.ticket_dispatch.kernel
        import repro_torch.models.model, repro_torch.serve
        import repro_torch.launch.serve
        repro_torch._build.ticket_constants_header()
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      "chip_smoke.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("clean")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
