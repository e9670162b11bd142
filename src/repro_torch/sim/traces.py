"""Trace→program compiler: recorded serve workloads as lockVM sweeps.

The serve layer records a ``LockTrace`` (the serve layer's recorded trace) (per-request
arrival / grant / release timestamps plus metadata reads).  This module
turns one into a first-class sweepable workload:

1. :func:`quantize_trace` maps the trace's empirical distributions into
   lockVM cost units — inverse-CDF quantile tables of critical-section
   work (hold times) and off-lock work (inter-acquire gaps), plus
   per-thread arrival offsets — producing a :class:`TraceWorkload`.
2. :func:`build_trace_bench` compiles a ``TraceWorkload`` against any of
   the 14 ``SIM_LOCKS`` algorithms: same acquire/release generators as
   ``build_mutexbench``, but per-iteration CS and outside work are *drawn
   from the trace's tables* (PRNG index → table LOAD → WORKR) instead of
   scalar axes, and each thread starts at its recorded arrival offset.
3. :func:`trace_sweep_spec` wraps it all in a ``SweepSpec`` whose
   coordinate axes are pinned to the trace's representative values, so
   results persist to the store under coordinates
   (:func:`trace_workload_coords`) the advisor can be queried with — the
   full serve → record → compile → sweep → recommend → serve loop.

Table draws use only the CS-safe scratch registers (R_W, R_G, R_DX): the
acquire/release generators keep R_TX / R_T1 / R_V live across the critical
section, and there is no reg+reg ADD in the ISA, so the address is formed
by subtracting a negated index (R_Z is pinned to 0 by ``init_state``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .isa import (JMP, LOAD, MOVI, PRNG, R_DX, R_G, R_TID, R_W, R_Z, SUB,
                  TSTART, WORDS_PER_SECTOR, WORKR, Asm)
from .programs import ACQUIRE_GEN, INIT_MEM_GEN, RELEASE_GEN, WORK_SCALE, Layout

DEFAULT_TABLE_SIZE = 32


def _align(w: int) -> int:
    return (w + WORDS_PER_SECTOR - 1) // WORDS_PER_SECTOR * WORDS_PER_SECTOR


@dataclass(frozen=True)
class TraceWorkload:
    """A quantized trace: everything the compiler and the advisor need.

    ``cs_table`` / ``out_table`` are inverse-CDF quantile tables in
    *cycles* (uniform PRNG index → empirical distribution sample);
    ``arrival_table`` is per-thread start offsets in cycles.  The ``_rep``
    fields are representative medians in PRNG-step units — they become
    the ``cs_work`` / ``outside_work`` sweep coordinates, so stored rows
    answer advisor queries phrased in the same units synthetic sweeps use.
    All tuples: the workload rides inside frozen ``SweepSpec`` instances.
    """

    name: str
    n_threads: int
    cs_table: tuple
    out_table: tuple
    arrival_table: tuple
    reader_fraction: int
    cs_work_rep: int
    outside_work_rep: int

    def as_meta(self) -> dict:
        """JSON-serializable form (fuzz scenario meta, provenance logs)."""
        return {"name": self.name, "n_threads": self.n_threads,
                "cs_table": list(self.cs_table),
                "out_table": list(self.out_table),
                "arrival_table": list(self.arrival_table),
                "reader_fraction": self.reader_fraction,
                "cs_work_rep": self.cs_work_rep,
                "outside_work_rep": self.outside_work_rep}


def workload_from_meta(meta: dict) -> TraceWorkload:
    return TraceWorkload(
        name=meta["name"], n_threads=int(meta["n_threads"]),
        cs_table=tuple(int(x) for x in meta["cs_table"]),
        out_table=tuple(int(x) for x in meta["out_table"]),
        arrival_table=tuple(int(x) for x in meta["arrival_table"]),
        reader_fraction=int(meta["reader_fraction"]),
        cs_work_rep=int(meta["cs_work_rep"]),
        outside_work_rep=int(meta["outside_work_rep"]))


def _concurrency(arrival_s, release_s) -> int:
    """Max simultaneously-outstanding requests (arrival→release overlap)."""
    events = sorted([(t, 1) for t in arrival_s] + [(t, -1) for t in release_s])
    depth = peak = 0
    for _, d in events:
        depth += d
        peak = max(peak, depth)
    return max(1, peak)


def _quantile_steps(samples, unit_s: float, table_size: int,
                    max_steps: int, *, min_steps: int) -> tuple:
    """Inverse-CDF table: entry i is the (i+0.5)/size quantile, in steps."""
    if len(samples) == 0:
        return (min_steps,) * table_size
    qs = (np.arange(table_size) + 0.5) / table_size
    d = np.quantile(np.asarray(samples, np.float64), qs)
    return tuple(int(s) for s in
                 np.clip(np.ceil(d / unit_s), min_steps, max_steps)
                 .astype(np.int64))


def quantize_trace(trace, *, name: str | None = None,
                   n_threads: int | None = None,
                   table_size: int = DEFAULT_TABLE_SIZE,
                   max_steps: int = 64,
                   unit_s: float | None = None) -> TraceWorkload:
    """Quantize a ``LockTrace`` (the serve layer's recorded trace) into cost units.

    ``unit_s`` is the wall-clock length of one PRNG step.  ``None``
    auto-derives it from the trace (p95 hold ≈ 16 steps), which normalizes
    away the recording machine's absolute speed; pass an explicit value to
    compare traces on a shared scale — with ``unit_s`` fixed, quantization
    is monotone (longer recorded holds never compile to less CS work).

    ``n_threads`` defaults to the trace's peak request concurrency — the
    number of clients actually contending the admission lock, which is the
    contention level the replay should reproduce (not the lane count).
    """
    hold = np.asarray(trace.hold_s, np.float64)
    if len(hold) == 0:
        raise ValueError("cannot quantize an empty trace")
    if unit_s is None:
        p95 = float(np.quantile(hold, 0.95))
        unit_s = max(p95 / 16.0, 1e-9)
    if n_threads is None:
        n_threads = _concurrency(trace.arrival_s, trace.release_s)

    cs_steps = _quantile_steps(hold, unit_s, table_size, max_steps,
                               min_steps=1)
    out_steps = _quantile_steps(trace.inter_acquire_s, unit_s, table_size,
                                max_steps, min_steps=0)
    # Arrival offsets: n_threads quantiles of the arrival process, so the
    # replay ramps up the way the recorded run did (offsets may exceed
    # max_steps — they are one-shot, not per-iteration).
    arr_qs = (np.arange(n_threads) + 0.5) / n_threads
    arr = np.quantile(np.asarray(trace.arrival_s, np.float64), arr_qs)
    arr_steps = np.clip(np.round(arr / unit_s), 0, 8 * max_steps)

    scale = WORK_SCALE
    return TraceWorkload(
        name=name if name is not None else trace.name,
        n_threads=int(n_threads),
        cs_table=tuple(int(s) * scale for s in cs_steps),
        out_table=tuple(int(s) * scale for s in out_steps),
        arrival_table=tuple(int(s) * scale for s in arr_steps.astype(np.int64)),
        reader_fraction=int(trace.reader_fraction),
        cs_work_rep=int(np.median(cs_steps)),
        outside_work_rep=int(np.median(out_steps)))


@dataclass
class TraceLayout(Layout):
    """Layout with the trace tables appended past the waiting array.

    ``[cs_table | out_table | arrival (one word per thread)]`` starting at
    the sector-aligned end of the base layout, so every base offset
    (locks, MCS nodes, waiting arrays) is untouched and the acquire /
    release generators run verbatim.
    """

    cs_len: int = DEFAULT_TABLE_SIZE
    out_len: int = DEFAULT_TABLE_SIZE

    @property
    def table_base(self) -> int:
        return Layout.mem_words.fget(self)

    @property
    def cs_base(self) -> int:
        return self.table_base

    @property
    def out_base(self) -> int:
        return self.table_base + self.cs_len

    @property
    def arrival_base(self) -> int:
        return self.out_base + self.out_len

    @property
    def mem_words(self) -> int:
        return _align(self.arrival_base + self.n_threads)


def trace_layout_for(tw: TraceWorkload, layout: Layout) -> TraceLayout:
    """Extend a cell's base layout with this workload's table geometry."""
    return TraceLayout(
        n_threads=layout.n_threads, n_locks=layout.n_locks,
        wa_size=layout.wa_size, private_arrays=layout.private_arrays,
        long_term_threshold=layout.long_term_threshold,
        sem_permits=layout.sem_permits,
        reader_fraction=layout.reader_fraction,
        count_collisions=layout.count_collisions,
        timo_patience=layout.timo_patience,
        cs_len=len(tw.cs_table), out_len=len(tw.out_table))


def _emit_table_draw(asm: Asm, base: int, length: int) -> None:
    """R_W <- table[lcg() % length]; charge it as work.

    Scratch only (R_W/R_G/R_DX): the address is base + index, formed as
    base - (0 - index) because the ISA has no reg+reg ADD and the add
    helper in programs.py clobbers R_V, which fissile-twa and twa-rw keep
    live across the critical section.
    """
    asm.emit(PRNG, R_W, 0, 0, length)
    asm.emit(MOVI, R_G, 0, 0, base)
    asm.emit(SUB, R_DX, R_Z, R_W, 0)
    asm.emit(SUB, R_G, R_G, R_DX, 0)
    asm.emit(LOAD, R_W, R_G, 0, 0)
    asm.emit(WORKR, R_W, 0, 0, 0)


def build_trace_bench(lock: str, layout: TraceLayout, tw: TraceWorkload, *,
                      collect_latency: bool = False) -> np.ndarray:
    """MutexBench with trace-drawn work: the recorded workload, replayed.

    Structure: one-shot arrival delay (``arrival_table[tid]``), then
    loop { acquire; CS work ~ cs_table; release; outside work ~ out_table }.
    Each iteration PRNG-indexes the quantile tables, so the simulated
    work *distribution* matches the recorded one while the sequence stays
    deterministic per seed — sweepable and differential-checkable like
    any synthetic program.
    """
    assert layout.n_locks == 1, "trace programs replay a single admission lock"
    assert len(tw.cs_table) == layout.cs_len
    assert len(tw.out_table) == layout.out_len
    asm = Asm()
    # Arrival: thread tid starts arrival_table[tid] cycles into the run.
    asm.emit(MOVI, R_G, 0, 0, layout.arrival_base)
    asm.emit(SUB, R_DX, R_Z, R_TID, 0)
    asm.emit(SUB, R_G, R_G, R_DX, 0)
    asm.emit(LOAD, R_W, R_G, 0, 0)
    asm.emit(WORKR, R_W, 0, 0, 0)
    asm.label("top")
    if collect_latency:
        asm.emit(TSTART, 0, 0, 0, 0)
    ACQUIRE_GEN[lock](asm, "a", layout)
    _emit_table_draw(asm, layout.cs_base, layout.cs_len)
    RELEASE_GEN[lock](asm, "r", layout)
    _emit_table_draw(asm, layout.out_base, layout.out_len)
    asm.emit(JMP, 0, 0, 0, "top")
    return asm.finish()


def trace_init_mem(lock: str, layout: TraceLayout,
                   tw: TraceWorkload) -> np.ndarray:
    """Initial memory: the lock's own init image plus the trace tables."""
    gen = INIT_MEM_GEN.get(lock)
    mem = gen(layout) if gen else np.zeros(layout.mem_words, np.int32)
    mem = np.asarray(mem, np.int32).copy()
    mem[layout.cs_base:layout.cs_base + layout.cs_len] = tw.cs_table
    mem[layout.out_base:layout.out_base + layout.out_len] = tw.out_table
    # Threads beyond the recorded concurrency cycle through the offsets.
    arr = [tw.arrival_table[t % len(tw.arrival_table)]
           for t in range(layout.n_threads)]
    mem[layout.arrival_base:layout.arrival_base + layout.n_threads] = arr
    return mem


def trace_workload_coords(tw: TraceWorkload) -> dict:
    """The advisor query this workload's sweep rows are stored under."""
    return {"n_threads": tw.n_threads, "cs_work": tw.cs_work_rep,
            "outside_work": tw.outside_work_rep,
            "reader_fraction": tw.reader_fraction}


def trace_sweep_spec(tw: TraceWorkload, *, locks=("ticket", "twa", "mcs"),
                     threads=None, seeds=(1, 2, 3), **kw):
    """A ``SweepSpec`` replaying this workload over ``locks``.

    The coordinate axes are pinned to the trace's representative values so
    every persisted row lands at :func:`trace_workload_coords` — the point
    ``recommend_lock`` is later queried at.
    """
    from .workloads import SweepSpec
    return SweepSpec(
        locks=tuple(locks),
        threads=threads if threads is not None else (tw.n_threads,),
        seeds=tuple(seeds),
        cs_work=(tw.cs_work_rep,),
        outside_work=(tw.outside_work_rep,),
        reader_fraction=(tw.reader_fraction,),
        trace=tw, **kw)
