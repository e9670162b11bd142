"""The lockVM's replayable scenarios and their ``.npz`` corpus format.

The lockVM has no weights.  What it runs on is the packed sweep arrays
(programs, initial pc/registers/memory, seeds, costs and fault schedules)
and the replayable fuzz corpus under ``tests/corpus/*.npz``, written by the
reference package's differential checker.  This module holds the one reader
and writer of that format in the port: the engines' tests replay the corpus
through it, and the port's checker (:mod:`repro_torch.sim.check`) builds,
saves and replays its scenarios with it.  A file written by either package
loads in the other.

Layout of one entry (``np.savez_compressed``): the arrays ``program``,
``init_pc``, ``init_regs``, ``init_mem`` and ``costs``, plus ``_meta`` — a
uint8 view of a JSON object holding ``kind``, ``lock``, ``note``, ``meta``
(whose ``faults`` entry, when present, is a list of ``[kind, evt, tid,
arg]`` rows) and the scalar fields below.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace as _dc_replace

import numpy as np

from .faults import FaultSchedule, stack_schedules

_ARRAY_FIELDS = ("program", "init_pc", "init_regs", "init_mem", "costs")
_SCALAR_FIELDS = ("n_active", "wa_base", "wa_size", "horizon", "max_events",
                  "seed", "n_threads", "mem_words", "n_locks")


@dataclass(frozen=True)
class Scenario:
    """One case: everything the oracle and an engine need to replay it.

    ``meta`` carries what the invariant checks read (``layout``, ``cap``,
    ``expect_classes``, ...), the fault schedule (``faults``) and the
    engine placement a case was pinned to (``torch_chunk``,
    ``cuda_state``; the reference's ``sched_geometry`` and
    ``pallas_chunk`` ride along untouched).
    """

    kind: str              # "random" | "composed" | "corpus-diff"
    lock: str | None
    program: np.ndarray    # (prog_len, 5) int32, padded
    init_pc: np.ndarray    # (n_threads,) int32
    init_regs: np.ndarray  # (n_threads, N_REGS) int32
    init_mem: np.ndarray   # (mem_words,) int32
    costs: np.ndarray      # (9,) int32
    n_active: int
    wa_base: int
    wa_size: int
    horizon: int
    max_events: int
    seed: int
    n_threads: int         # padded shapes shared by a batch
    mem_words: int
    n_locks: int
    meta: dict

    def replace(self, **kw) -> "Scenario":
        return _dc_replace(self, **kw)

    def engine_kwargs(self) -> dict:
        """Single-cell keyword arguments of the checker's oracles."""
        return dict(n_threads=self.n_threads, mem_words=self.mem_words,
                    n_locks=self.n_locks, init_pc=self.init_pc,
                    init_regs=self.init_regs, init_mem=self.init_mem,
                    n_active=self.n_active, seed=self.seed,
                    wa_base=self.wa_base, wa_size=self.wa_size,
                    horizon=self.horizon, max_events=self.max_events,
                    costs=self.costs, faults=self.faults())

    def faults(self) -> FaultSchedule | None:
        """The scenario's fault schedule (``meta["faults"]``), or None."""
        rows = self.meta.get("faults")
        if not rows:
            return None
        sched = FaultSchedule.from_lists(rows)
        return sched if len(sched) else None


def load_scenario(path) -> Scenario:
    """Read one corpus entry (``tests/corpus/*.npz``)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta"]).decode())
        arrays = {k: z[k] for k in _ARRAY_FIELDS}
    return Scenario(kind=meta["kind"], lock=meta["lock"], meta=meta["meta"],
                    **arrays, **{k: int(meta[k]) for k in _SCALAR_FIELDS})


def save_scenario(path, scenario: Scenario, note: str = "") -> None:
    """Write ``scenario`` as a replayable corpus entry (arrays + JSON)."""
    meta = dict(kind=scenario.kind, lock=scenario.lock, note=note,
                meta=scenario.meta,
                **{k: int(getattr(scenario, k)) for k in _SCALAR_FIELDS})
    np.savez_compressed(
        path, _meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
        **{k: np.asarray(getattr(scenario, k)) for k in _ARRAY_FIELDS})


def scenario_sweep_args(scenarios: list[Scenario]) -> tuple[np.ndarray, dict]:
    """``(programs, kwargs)`` for :func:`repro_torch.sim.engine.run_sweep`.

    The scenarios must share padded shapes (the corpus does).  A fault
    schedule rides along when any scenario carries one; the others get an
    empty schedule, which is an exact no-op.
    """
    s0 = scenarios[0]
    for s in scenarios:
        if (s.n_threads, s.mem_words, s.n_locks) != \
                (s0.n_threads, s0.mem_words, s0.n_locks):
            raise ValueError("scenarios do not share padded shapes")
    kw = dict(
        mem_words=s0.mem_words, n_locks=s0.n_locks,
        init_pc=np.stack([s.init_pc for s in scenarios]),
        init_regs=np.stack([s.init_regs for s in scenarios]),
        n_active=np.asarray([s.n_active for s in scenarios]),
        seeds=np.asarray([s.seed for s in scenarios], np.uint32),
        wa_base=np.asarray([s.wa_base for s in scenarios]),
        wa_size=np.asarray([s.wa_size for s in scenarios]),
        horizon=np.asarray([s.horizon for s in scenarios], np.int32),
        max_events=np.asarray([s.max_events for s in scenarios], np.int32),
        costs=np.stack([s.costs for s in scenarios]),
        init_mem=np.stack([s.init_mem for s in scenarios]))
    scheds = [s.faults() for s in scenarios]
    if any(sc is not None for sc in scheds):
        kw["faults"] = stack_schedules(
            [sc if sc is not None else FaultSchedule.empty() for sc in scheds])
    return np.stack([s.program for s in scenarios]), kw
