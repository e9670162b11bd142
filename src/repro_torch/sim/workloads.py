"""Benchmark workloads on the lockVM, one per paper figure.

Sweep-first API: a :class:`SweepSpec` names the axes of a figure (lock ×
threads × seeds × cs_work × private_arrays × costs) and :func:`run_sweep`
executes the whole cartesian product as ONE engine call — on a GPU, one
launch of the lockVM kernel.  Every cell is padded to the sweep-wide
maximum shapes (threads, memory, program length).  ``run_contention`` /
``median_throughput`` / ``mutexbench_curve`` are thin layers over it.

Every entry point takes ``device`` (default ``cuda``; with no GPU and no
device given it raises) and passes it to :func:`repro_torch.sim.engine.
run_sweep`.  When ``$REPRO_RESULTS_STORE`` names a file, every sweep
appends its cells there (:mod:`repro_torch.sim.results`).
"""

from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass

import numpy as np

from .. import spans
from . import engine
from .costs import DEFAULT_COSTS, Costs
from .faults import FaultSchedule, draw_schedule, stack_schedules
from .programs import (INIT_MEM_GEN, LT_THRESHOLD, Layout,
                       build_invalidation_diameter, build_mutexbench,
                       init_state, pad_mem, pad_program, pad_threads)

DEFAULT_HORIZON = 1_500_000
DEFAULT_MAX_EVENTS = 2_000_000


def _as_tuple(x) -> tuple:
    """Normalize a scalar-or-sequence axis value to a tuple."""
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


@dataclass(frozen=True)
class SweepCell:
    """One concrete point of a sweep (all axes resolved)."""

    lock: str
    n_threads: int
    seed: int
    cs_work: int
    outside_work: int
    private_arrays: bool
    costs: Costs
    wa_size: int
    long_term_threshold: int
    sem_permits: int
    reader_fraction: int
    preempt_faults: int
    spurious_faults: int
    abort_faults: int


@dataclass(frozen=True)
class SweepSpec:
    """Declarative description of a lockVM parameter sweep.

    The leading fields (through ``abort_faults``) are *axes*: each accepts
    a single value or a sequence, and :meth:`cells` yields their cartesian
    product in field order (locks outermost, abort_faults innermost).  The
    remaining fields are scalar knobs shared by every cell.  The
    ``outside_work`` axis is a fixed delay (PRNG steps) between release and
    the next acquisition attempt — guaranteed off-lock time that caps the
    per-thread arrival rate independently of the random NCS draw.  The ``sem_permits``
    axis maps the mutex→semaphore continuum: permits=1 is a FIFO mutex,
    permits→T approaches uncontended entry (only twa-sem consumes it).
    The ``reader_fraction`` axis (percent of acquisitions that are reads)
    maps the writer-only→read-only continuum; only twa-rw consumes it.

    The three ``*_faults`` axes inject deterministic fault schedules
    (:mod:`repro_torch.sim.faults`): per cell, that many preemption windows /
    spurious wakeups / thread aborts are drawn from an rng seeded off the
    cell coordinates, so a given cell's schedule is reproducible across
    sweep shapes.  ``preempt_cost`` (scalar knob) is the stall K charged
    per preemption; ``fault_evt_span`` bounds the event indices faults
    land on (pass the expected executed-event count so faults hit inside
    the run).  When every fault axis is 0 the engine is invoked with
    ``faults=None`` — the exact historical call, bit-identical results.
    """

    locks: tuple | str = ("ticket", "twa", "mcs")
    threads: tuple | int = (1, 2, 4, 8, 16, 32, 64)
    seeds: tuple | int = (1, 2, 3)
    cs_work: tuple | int = 4
    outside_work: tuple | int = 0        # fixed non-CS delay per iteration
    private_arrays: tuple | bool = False
    costs: tuple | Costs = DEFAULT_COSTS
    wa_size: tuple | int = 4096          # waiting-array slots (pow2, Fig 8)
    long_term_threshold: tuple | int = LT_THRESHOLD  # TWA-family split point
    sem_permits: tuple | int = 4         # twa-sem capacity (axis)
    reader_fraction: tuple | int = 50    # twa-rw read percent (axis, Fig 10)
    preempt_faults: tuple | int = 0      # preemption windows per run (axis)
    spurious_faults: tuple | int = 0     # spurious wakeups per run (axis)
    abort_faults: tuple | int = 0        # thread aborts per run (axis)
    ncs_max: int = 200
    cs_rand: tuple | None = None
    n_locks: int = 1
    horizon: int = DEFAULT_HORIZON
    max_events: int = DEFAULT_MAX_EVENTS
    count_collisions: bool = False       # TWA family: tally wakeups (Fig 8)
    collect_latency: bool = False        # TSTART brackets -> lat_hist +
    #                                      lat_p50/p99/p999 result columns
    preempt_cost: int = 4096             # stall cycles K per preemption
    fault_evt_span: int | None = None    # bound on fault event indices
    trace: object | None = None          # TraceWorkload: replay a recorded
    #                                      serve trace instead of the scalar
    #                                      cs_work/outside_work axes (see
    #                                      repro_torch.sim.traces.trace_sweep_spec)

    def cells(self) -> list[SweepCell]:
        return [SweepCell(lock=lk, n_threads=t, seed=s, cs_work=cw,
                          outside_work=ow, private_arrays=pa, costs=co,
                          wa_size=ws, long_term_threshold=lt, sem_permits=sp,
                          reader_fraction=rf, preempt_faults=pf,
                          spurious_faults=sf, abort_faults=af)
                for lk, t, s, cw, ow, pa, co, ws, lt, sp, rf, pf, sf, af
                in itertools.product(
                    _as_tuple(self.locks), _as_tuple(self.threads),
                    _as_tuple(self.seeds), _as_tuple(self.cs_work),
                    _as_tuple(self.outside_work),
                    _as_tuple(self.private_arrays), _as_tuple(self.costs),
                    _as_tuple(self.wa_size),
                    _as_tuple(self.long_term_threshold),
                    _as_tuple(self.sem_permits),
                    _as_tuple(self.reader_fraction),
                    _as_tuple(self.preempt_faults),
                    _as_tuple(self.spurious_faults),
                    _as_tuple(self.abort_faults))]

    def fault_schedule_for(self, cell: SweepCell) -> FaultSchedule:
        """The cell's deterministic fault schedule (empty when all axes 0).

        Seeded off the cell coordinates — not the cell's position in the
        sweep — so the same (seed, threads, fault counts) cell draws the
        same schedule no matter which other axes the sweep carries.
        """
        total = cell.preempt_faults + cell.spurious_faults + cell.abort_faults
        if total == 0:
            return FaultSchedule.empty()
        rng = np.random.default_rng(
            [0xFA17, cell.seed, cell.n_threads, cell.preempt_faults,
             cell.spurious_faults, cell.abort_faults])
        span = (self.max_events if self.fault_evt_span is None
                else self.fault_evt_span)
        return draw_schedule(
            rng, n_active=cell.n_threads, max_events=self.max_events,
            n_preempt=cell.preempt_faults, n_spurious=cell.spurious_faults,
            n_abort=cell.abort_faults,
            k_range=(self.preempt_cost, self.preempt_cost), evt_span=span)

    def layout_for(self, cell: SweepCell) -> Layout:
        return Layout(n_threads=cell.n_threads, n_locks=self.n_locks,
                      wa_size=cell.wa_size, private_arrays=cell.private_arrays,
                      long_term_threshold=cell.long_term_threshold,
                      sem_permits=cell.sem_permits,
                      reader_fraction=cell.reader_fraction,
                      count_collisions=self.count_collisions)


def run_sweep(spec: SweepSpec, *, mode: str = "auto",
              chunk: int | None = None, device=None) -> list[dict]:
    """Run every cell of ``spec`` in one engine call.

    Returns one dict per cell, in :meth:`SweepSpec.cells` order.  Each dict
    carries the cell coordinates (``lock``, ``n_threads``, ``seed``,
    ``cs_work``, ``private_arrays``) plus the same stats ``run_sim``
    produces (``throughput``, ``acquisitions``, ``avg_handover``, ``mem``,
    ...), with per-thread arrays sliced to the cell's real thread count,
    plus the sweep-wide ``mode`` (the resolved engine) and ``pad_stats``
    (padding-waste report) bookkeeping.  ``mode`` selects the engine (see
    :func:`repro_torch.sim.engine.run_sweep`: ``"cuda"``, ``"torch"``, or
    the default ``"auto"``, which picks by device; ``chunk`` configures the
    ``"torch"`` engine's termination checks); results are mode-independent.
    """
    return run_sweeps([spec], mode=mode, chunk=chunk, device=device)[0]


def run_sweeps(specs, *, mode: str = "auto", chunk: int | None = None,
               device=None) -> list[list[dict]]:
    """Run the cells of several specs in ONE engine call (one kernel launch
    on a GPU); returns :func:`run_sweep`'s rows for each spec, in order.

    The specs must share ``n_locks``; everything else (axes, horizon,
    event budget, faults) may differ — fig3's ``twa-timo`` cells, which its
    generator caps at 32 threads, ride with the other locks' 64-thread
    cells this way.

    With ``$REPRO_RESULTS_STORE`` set, every cell is appended to that
    results store once, here (:func:`run_sweep` goes through this call).
    """
    with spans.span("sweep.run") as sp:
        with spans.span("sweep.build"):
            programs, kwargs, rows = sweep_engine_args(specs)
        raw = engine.run_sweep(programs, **kwargs, mode=mode, chunk=chunk,
                               device=device)
        with spans.span("sweep.rows"):
            out = [[] for _ in specs]
            for i, (k, spec, cell, layout, sched) in enumerate(rows):
                out[k].append(_result_row(spec, cell, layout, sched, raw, i))
            store_path = os.environ.get(RESULTS_STORE_ENV)
            if store_path:
                from .results.store import ResultsStore
                ResultsStore(store_path).append_sweep(
                    [res for results in out for res in results])
        if sp:
            sp.count("cells", len(rows))
            sp.count("sum_events", raw["pad_stats"]["sum_events"])
            sp.count("max_events", raw["pad_stats"]["max_events"])
    return out


# Environment hook: when set, every run_sweeps() (and so every run_sweep())
# appends its result rows to the JSONL results store at this path (see
# repro_torch.sim.results).
RESULTS_STORE_ENV = "REPRO_RESULTS_STORE"


def _build_cell(spec: SweepSpec, cell: SweepCell):
    """``(layout, program, init_pc, init_regs, init_mem)`` of one cell."""
    layout = spec.layout_for(cell)
    if spec.trace is not None:
        # Trace-compiled cell: CS/outside work come from the recorded
        # distribution tables, not the scalar axes (which the spec pins
        # to the trace's representative values for coordinate purposes).
        from .traces import (build_trace_bench, trace_init_mem,
                             trace_layout_for)
        layout = trace_layout_for(spec.trace, layout)
        prog = build_trace_bench(cell.lock, layout, spec.trace,
                                 collect_latency=spec.collect_latency)
        pc, regs = init_state(layout)
        init_mem = trace_init_mem(cell.lock, layout, spec.trace)
    else:
        prog = build_mutexbench(cell.lock, layout, cs_work=cell.cs_work,
                                ncs_max=spec.ncs_max, cs_rand=spec.cs_rand,
                                outside_work=cell.outside_work,
                                collect_latency=spec.collect_latency)
        pc, regs = init_state(layout)
        gen_mem = INIT_MEM_GEN.get(cell.lock)
        init_mem = (gen_mem(layout) if gen_mem
                    else np.zeros(layout.mem_words, np.int32))
    return layout, prog, pc, regs, init_mem


def sweep_engine_args(specs) -> tuple[np.ndarray, dict, list]:
    """Pack the cells of ``specs`` for one :func:`engine.run_sweep` call.

    Returns ``(programs, kwargs, rows)``: every cell padded to the shared
    maximum shapes, and per cell ``(spec index, spec, cell, layout, fault
    schedule)`` in engine order.
    """
    specs = list(specs)
    if len({spec.n_locks for spec in specs}) != 1:
        raise ValueError("specs run in one engine call must share n_locks")
    rows, built = [], []
    for k, spec in enumerate(specs):
        for cell in spec.cells():
            built.append(_build_cell(spec, cell))
            rows.append((k, spec, cell, built[-1][0],
                         spec.fault_schedule_for(cell)))

    t_max = max(layout.n_threads for layout, *_ in built)
    m_max = max(layout.mem_words for layout, *_ in built)
    padded = [pad_threads(pc, regs, t_max) for _, _, pc, regs, _ in built]
    scheds = [sched for *_, sched in rows]
    # faults=None when no cell schedules any fault: the engines then skip
    # the fault phase entirely.
    faults = (stack_schedules(scheds) if any(len(s) for s in scheds)
              else None)
    kwargs = dict(
        mem_words=m_max, n_locks=specs[0].n_locks,
        init_pc=np.stack([pc for pc, _ in padded]),
        init_regs=np.stack([regs for _, regs in padded]),
        n_active=np.asarray([layout.n_threads for layout, *_ in built]),
        seeds=np.asarray([row[2].seed for row in rows], np.uint32),
        wa_base=np.asarray([layout.wa_base for layout, *_ in built]),
        wa_size=np.asarray([layout.wa_size for layout, *_ in built]),
        horizon=np.asarray([row[1].horizon for row in rows], np.int32),
        max_events=np.asarray([row[1].max_events for row in rows], np.int32),
        costs=np.stack([row[2].costs.to_array() for row in rows]),
        init_mem=np.stack([pad_mem(init_mem, m_max)
                           for *_, init_mem in built]),
        live_mem_words=np.asarray([layout.mem_words
                                   for layout, *_ in built]),
        faults=faults,
    )
    programs = np.stack([pad_program(prog) for _, prog, *_ in built])
    return programs, kwargs, rows


def _result_row(spec: SweepSpec, cell: SweepCell, layout: Layout,
                sched: FaultSchedule, raw: dict, i: int) -> dict:
    t = layout.n_threads
    res = {
        "lock": cell.lock, "n_threads": t, "seed": cell.seed,
        "cs_work": cell.cs_work, "outside_work": cell.outside_work,
        "private_arrays": cell.private_arrays,
        "costs": cell.costs, "wa_size": cell.wa_size,
        "long_term_threshold": cell.long_term_threshold,
        "sem_permits": cell.sem_permits,
        "reader_fraction": cell.reader_fraction,
        "preempt_faults": cell.preempt_faults,
        "spurious_faults": cell.spurious_faults,
        "abort_faults": cell.abort_faults,
        "fault_schedule": sched,
        "layout": layout,  # the run's OWN layout (collision readers
        #                    must not reconstruct it by hand)
        "acquisitions": raw["acquisitions"][i, :t],
        "waited_acquisitions": raw["waited_acquisitions"][i, :t],
        "handover_sum": raw["handover_sum"][i],
        "handover_count": raw["handover_count"][i],
        "events": raw["events"][i],
        "sleeping": raw["sleeping"][i],
        "mem": raw["grant_value"][i, :layout.mem_words],
        "horizon": spec.horizon,
        "n_locks": spec.n_locks,
        "mode": raw["mode"],          # resolved engine (mode="auto")
        "pad_stats": raw["pad_stats"],  # sweep-wide padding waste
        "workload": (f"trace:{spec.trace.name}" if spec.trace is not None
                     else "synthetic"),
    }
    res["throughput"] = float(res["acquisitions"].sum()) / spec.horizon
    hc = int(res["handover_count"])
    res["avg_handover"] = (float(res["handover_sum"]) / hc if hc
                           else float("nan"))
    if spec.collect_latency:
        hist = np.asarray(raw["lat_hist"][i])
        res["lat_hist"] = hist
        res["lat_p50"] = hist_percentile(hist, 0.5)
        res["lat_p99"] = hist_percentile(hist, 0.99)
        res["lat_p999"] = hist_percentile(hist, 0.999)
    return res


def hist_percentile(hist, q: float) -> float:
    """The q-th percentile latency from a log2 acquire-latency histogram.

    Bucket 0 holds exact-zero latencies; bucket k >= 1 holds latencies in
    ``[2^(k-1), 2^k)`` and is represented by its inclusive upper edge
    ``2^k - 1`` (pessimistic: tail percentiles never under-report).  The
    sample of rank ``max(1, ceil(q * total))`` in bucket order picks the
    bucket.  Returns NaN for an empty histogram (no TSTART-marked
    acquisitions completed).
    """
    hist = np.asarray(hist)
    total = int(hist.sum())
    if total == 0:
        return float("nan")
    rank = max(1, math.ceil(q * total))
    k = int(np.searchsorted(np.cumsum(hist), rank))
    return float((1 << k) - 1 if k else 0)


def latency_percentiles(result: dict,
                        qs=(0.5, 0.99, 0.999)) -> tuple[float, ...]:
    """Percentiles from one :func:`run_sweep` result row.

    Raises ``ValueError`` if the sweep ran without latency collection —
    percentile columns from a histogram-disabled sweep would silently be
    garbage, exactly like reading collision counters from an
    uninstrumented run.
    """
    if "lat_hist" not in result:
        raise ValueError(
            "latency_percentiles: this sweep ran with collect_latency=False "
            "— the programs never emitted TSTART marks, so no acquire "
            "latencies were sampled. Re-run with "
            "SweepSpec(collect_latency=True) and read the lat_p* columns "
            "(or pass the row here).")
    return tuple(hist_percentile(result["lat_hist"], q) for q in qs)


def sweep_curves(spec: SweepSpec, value: str = "throughput", *,
                 device=None) -> dict:
    """Collapse a sweep to ``{lock: [median-over-seeds per thread count]}``.

    Medians are over the seeds axis (the paper reports the median of 5-7
    runs); any cs_work/private_arrays/costs axes must be singletons.
    """
    assert len(_as_tuple(spec.cs_work)) == 1
    assert len(_as_tuple(spec.outside_work)) == 1
    assert len(_as_tuple(spec.private_arrays)) == 1
    assert len(_as_tuple(spec.costs)) == 1
    assert len(_as_tuple(spec.wa_size)) == 1
    assert len(_as_tuple(spec.long_term_threshold)) == 1
    assert len(_as_tuple(spec.sem_permits)) == 1
    assert len(_as_tuple(spec.reader_fraction)) == 1
    assert len(_as_tuple(spec.preempt_faults)) == 1
    assert len(_as_tuple(spec.spurious_faults)) == 1
    assert len(_as_tuple(spec.abort_faults)) == 1
    results = run_sweep(spec, device=device)
    by_cell = {(r["lock"], r["n_threads"], r["seed"]): r[value]
               for r in results}
    return {lock: [float(np.median([by_cell[lock, t, s]
                                    for s in _as_tuple(spec.seeds)]))
                   for t in _as_tuple(spec.threads)]
            for lock in _as_tuple(spec.locks)}


def pack_engine_cells(cells, *, cs_work: int = 4, ncs_max: int = 200,
                      n_locks: int = 1, seeds=1,
                      collect_latency: bool = False) -> tuple[np.ndarray,
                                                              dict]:
    """Pad mixed ``(lock, n_threads, horizon)`` cells into one engine call.

    The :class:`SweepSpec` path shares a single horizon across the sweep;
    this is the low-level packer for deliberately *skewed* sweeps — every
    cell carries its own horizon.  Returns ``(programs, kwargs)`` ready
    for ``engine.run_sweep(programs, **kwargs)``.
    """
    layouts = [Layout(n_threads=t, n_locks=n_locks) for _, t, _ in cells]
    t_max = max(layout.n_threads for layout in layouts)
    m_max = max(layout.mem_words for layout in layouts)
    progs, pcs, regss, mems = [], [], [], []
    for (lock, _, _), layout in zip(cells, layouts):
        prog = build_mutexbench(lock, layout, cs_work=cs_work,
                                ncs_max=ncs_max,
                                collect_latency=collect_latency)
        pc, regs = init_state(layout)
        pc, regs = pad_threads(pc, regs, t_max)
        gen_mem = INIT_MEM_GEN.get(lock)
        init_mem = gen_mem(layout) if gen_mem else np.zeros(layout.mem_words,
                                                            np.int32)
        progs.append(pad_program(prog))
        pcs.append(pc)
        regss.append(regs)
        mems.append(pad_mem(init_mem, m_max))
    return np.stack(progs), dict(
        mem_words=m_max, n_locks=n_locks,
        init_pc=np.stack(pcs), init_regs=np.stack(regss),
        n_active=np.asarray([layout.n_threads for layout in layouts]),
        seeds=np.asarray(seeds, np.uint32),
        wa_base=np.asarray([layout.wa_base for layout in layouts]),
        wa_size=np.asarray([layout.wa_size for layout in layouts]),
        horizon=np.asarray([h for *_, h in cells], np.int32),
        init_mem=np.stack(mems),
        live_mem_words=np.asarray([layout.mem_words for layout in layouts]))


def run_contention(lock: str, n_threads: int, *, cs_work: int = 4,
                   ncs_max: int = 200, cs_rand: tuple | None = None,
                   n_locks: int = 1, private_arrays: bool = False,
                   horizon: int = DEFAULT_HORIZON, seed: int = 1,
                   costs: Costs = DEFAULT_COSTS,
                   max_events: int = DEFAULT_MAX_EVENTS, device=None,
                   **spec_kw) -> dict:
    """One MutexBench-style cell: throughput + handover stats.

    Extra keyword args (``wa_size``, ``long_term_threshold``, ``sem_permits``,
    ``count_collisions``, ...) pass straight through to :class:`SweepSpec`.
    """
    spec = SweepSpec(locks=lock, threads=n_threads, seeds=seed,
                     cs_work=cs_work, private_arrays=private_arrays,
                     costs=costs, ncs_max=ncs_max, cs_rand=cs_rand,
                     n_locks=n_locks, horizon=horizon, max_events=max_events,
                     **spec_kw)
    return run_sweep(spec, device=device)[0]


def median_throughput(lock: str, n_threads: int, *, runs: int = 3,
                      device=None, **kw) -> float:
    """Median over seeds (paper uses median of 5-7 runs)."""
    spec = SweepSpec(locks=lock, threads=n_threads,
                     seeds=tuple(range(1, runs + 1)), **kw)
    vals = [r["throughput"] for r in run_sweep(spec, device=device)]
    return float(np.median(vals))


def mutexbench_curve(locks=("ticket", "twa", "mcs"),
                     threads=(1, 2, 4, 8, 16, 32, 64), *, runs: int = 3,
                     device=None, **kw) -> dict[str, list[float]]:
    """Fig 3: throughput vs thread count per lock algorithm — one engine
    call for the whole figure."""
    spec = SweepSpec(locks=tuple(locks), threads=tuple(threads),
                     seeds=tuple(range(1, runs + 1)), **kw)
    return sweep_curves(spec, device=device)


def fig1_invalidation_diameter(reader_counts=(0, 1, 3, 7, 15, 31, 63),
                               *, horizon: int = 300_000,
                               seed: int = 1, device=None) -> list[float]:
    """Fig 1: writer FADD throughput vs number of polling readers.

    All reader counts are batched into one engine call: thread 0 is
    the writer, padded threads beyond ``readers + 1`` stay inactive.
    """
    prog, reader_pc = build_invalidation_diameter()
    t_max = max(reader_counts) + 1
    layouts = [Layout(n_threads=r + 1, n_locks=1) for r in reader_counts]
    m_max = max(layout.mem_words for layout in layouts)
    pcs, regss = [], []
    for layout in layouts:
        entries = np.full(layout.n_threads, reader_pc, np.int32)
        entries[0] = 0  # thread 0 is the writer
        pc, regs = init_state(layout, entries)
        pc, regs = pad_threads(pc, regs, t_max)
        pcs.append(pc)
        regss.append(regs)
    raw = engine.run_sweep(
        np.stack([pad_program(prog)] * len(layouts)),
        mem_words=m_max, n_locks=1,
        init_pc=np.stack(pcs), init_regs=np.stack(regss),
        n_active=np.asarray([layout.n_threads for layout in layouts]),
        seeds=np.uint32(seed),
        wa_base=np.asarray([layout.wa_base for layout in layouts]),
        wa_size=layouts[0].wa_size, horizon=horizon, max_events=3_000_000,
        device=device,
    )
    return [float(raw["acquisitions"][i, 0]) / horizon
            for i in range(len(layouts))]


def fig2_interlock_interference(pool_sizes=(1, 4, 16, 64, 256, 1024),
                                *, n_threads: int = 64, runs: int = 3,
                                horizon: int = 600_000,
                                device=None) -> list[float]:
    """Fig 2: shared-array TWA throughput / private-array TWA throughput.

    The paper sweeps 1..8192 locks on real hardware; we sweep to 1024 (memory
    for per-lock private arrays bounds the idealized variant).  <1.0 means
    inter-lock collisions/false-sharing cost; paper's worst case is ~8%.
    Each pool size is one sweep over the (private_arrays × seeds) axes.
    """
    ratios = []
    for n_locks in pool_sizes:
        spec = SweepSpec(locks="twa", threads=n_threads,
                         seeds=tuple(range(1, runs + 1)), cs_work=50,
                         private_arrays=(False, True), ncs_max=100,
                         n_locks=n_locks, horizon=horizon)
        results = run_sweep(spec, device=device)
        shared = np.median([r["throughput"] for r in results
                            if not r["private_arrays"]])
        private = np.median([r["throughput"] for r in results
                             if r["private_arrays"]])
        ratios.append(float(shared / private))
    return ratios
