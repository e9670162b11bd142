"""Deterministic fault schedules for the lockVM.

A fault schedule is a tiny per-cell table of ``(kind, evt, tid, arg)``
entries: at global event index ``evt`` the engine applies fault ``kind`` to
thread ``tid`` *before* selecting that step's event.  Schedules are plain
int32 arrays, so they ride through ``run_sweep`` as traced inputs — a sweep
over preemption rates is one compile, exactly like a sweep over costs.

Fault kinds (semantics live in ``engine._step`` under the
extended :data:`repro_torch.sim.engine.EVENT_ORDER_CONTRACT`):

* ``F_PREEMPT`` — freeze thread ``tid`` for ``arg`` cost units: a *running*
  thread's ``next_time`` slips by ``arg``; a parked/halted thread instead
  accumulates ``arg`` into its ``wake_delay``, paid on top of ``C_WAKE`` at
  its next wakeup (the OS descheduled it while it slept — it is late to the
  wake).  Pending stores are untouched: a store already belongs to the
  coherence system, preempting its issuer cannot stop the line transfer.
* ``F_SPURIOUS`` — a parked thread (``spin_addr >= 0``) resumes at
  ``now + C_WAKE + wake_delay`` with its pc still on the SPIN op: it re-pays
  the refill load, re-evaluates the condition, and re-parks if it still
  fails.  A no-op on a thread that is not parked.
* ``F_ABORT`` — the thread dies at this point: ``next_time = INF`` and
  ``spin_addr = -1`` (never wakeable — distinct from parked).  Its pending
  store, if any, still commits.

Determinism rules (what makes schedules differential-checkable):

* event indices are unique within a schedule — at most one fault per global
  event index, so vectorized application order can never matter;
* faults only apply while the run is live (``events < max_events`` and the
  earliest pre-fault event time < horizon).  A stalled or finished run
  executes no further events, so scheduled faults past that point never
  fire — a spurious wake cannot resurrect a stalled run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Default schedule capacity for fuzz scenarios; sweeps may size their own.
DEFAULT_MAX_FAULTS = 16

F_NONE, F_PREEMPT, F_SPURIOUS, F_ABORT = 0, 1, 2, 3
F_NAMES = {F_NONE: "none", F_PREEMPT: "preempt",
           F_SPURIOUS: "spurious", F_ABORT: "abort"}

# Preemption-window bounds for drawn schedules (cost units a frozen thread
# loses): wide enough to push a holder well past a handover, small enough
# that int32 time arithmetic stays far from wrapping.
DEFAULT_K_RANGE = (8, 512)


@dataclass(frozen=True)
class FaultSchedule:
    """One cell's fault table: parallel ``(n,)`` int32 arrays."""

    kind: np.ndarray
    evt: np.ndarray
    tid: np.ndarray
    arg: np.ndarray

    def __post_init__(self):
        for f in ("kind", "evt", "tid", "arg"):
            object.__setattr__(self, f, np.asarray(getattr(self, f), np.int32))
        n = len(self.kind)
        assert self.evt.shape == self.tid.shape == self.arg.shape == (n,), \
            (self.kind.shape, self.evt.shape, self.tid.shape, self.arg.shape)

    @property
    def n(self) -> int:
        return int((self.kind != F_NONE).sum())

    def __len__(self) -> int:
        return len(self.kind)

    def validate(self, *, n_threads: int, max_events: int) -> None:
        live = self.kind != F_NONE
        assert np.isin(self.kind, list(F_NAMES)).all(), self.kind
        assert ((self.tid >= 0) & (self.tid < n_threads))[live].all(), self.tid
        assert ((self.evt >= 0) & (self.evt < max_events))[live].all(), self.evt
        assert (self.arg[live & (self.kind == F_PREEMPT)] > 0).all(), self.arg
        evts = self.evt[live]
        assert len(np.unique(evts)) == len(evts), \
            f"duplicate fault event indices: {sorted(evts)}"

    def padded(self, max_faults: int) -> tuple[np.ndarray, ...]:
        """``(kind, evt, tid, arg)`` padded to ``(max_faults,)`` each.

        Pad rows are ``kind = F_NONE`` with zeroed fields, which the engine's
        application mask ignores.
        """
        n = len(self.kind)
        assert n <= max_faults, (n, max_faults)
        out = []
        for a in (self.kind, self.evt, self.tid, self.arg):
            pad = np.zeros(max_faults, np.int32)
            pad[:n] = a
            out.append(pad)
        return tuple(out)

    def counts(self) -> dict[str, int]:
        """Applied-kind histogram (coverage-signature feed)."""
        return {F_NAMES[k]: int((self.kind == k).sum())
                for k in (F_PREEMPT, F_SPURIOUS, F_ABORT)}

    def to_lists(self) -> list[list[int]]:
        """JSON-serializable form for scenario ``meta`` / corpus entries."""
        return [[int(k), int(e), int(t), int(a)]
                for k, e, t, a in zip(self.kind, self.evt, self.tid, self.arg)
                if k != F_NONE]

    @classmethod
    def from_lists(cls, rows) -> "FaultSchedule":
        rows = [r for r in rows if int(r[0]) != F_NONE]
        if not rows:
            return cls(*(np.zeros(0, np.int32),) * 4)
        arr = np.asarray(rows, np.int32)
        return cls(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3])

    @classmethod
    def empty(cls) -> "FaultSchedule":
        return cls(*(np.zeros(0, np.int32),) * 4)


def draw_schedule(rng: np.random.Generator, *, n_active: int, max_events: int,
                  n_preempt: int = 0, n_spurious: int = 0, n_abort: int = 0,
                  k_range: tuple[int, int] = DEFAULT_K_RANGE,
                  evt_span: int | None = None) -> FaultSchedule:
    """Draw a valid schedule: unique event indices, tids within ``n_active``.

    ``evt_span`` bounds the event indices drawn (default ``max_events``);
    pass the expected executed-event count so faults land inside the run
    instead of being scheduled past its end.
    """
    total = n_preempt + n_spurious + n_abort
    if total == 0:
        return FaultSchedule.empty()
    span = max_events if evt_span is None else min(evt_span, max_events)
    span = max(span, 1)
    total = min(total, span)  # unique indices need span >= total
    evts = rng.choice(span, size=total, replace=False).astype(np.int32)
    evts.sort()
    kinds = np.concatenate([
        np.full(n_preempt, F_PREEMPT, np.int32),
        np.full(n_spurious, F_SPURIOUS, np.int32),
        np.full(n_abort, F_ABORT, np.int32)])[:total]
    rng.shuffle(kinds)
    tids = rng.integers(0, max(n_active, 1), size=total).astype(np.int32)
    args = np.where(kinds == F_PREEMPT,
                    rng.integers(k_range[0], k_range[1] + 1, size=total),
                    0).astype(np.int32)
    sched = FaultSchedule(kinds, evts, tids, args)
    sched.validate(n_threads=max(n_active, 1), max_events=max_events)
    return sched


def stack_schedules(schedules, max_faults: int | None = None
                    ) -> tuple[np.ndarray, ...]:
    """Stack per-cell schedules into four ``(B, max_faults)`` int32 arrays
    (the ``faults=`` input of :func:`repro_torch.sim.engine.run_sweep`)."""
    schedules = list(schedules)
    if max_faults is None:
        max_faults = max([len(s.kind) for s in schedules] + [1])
    cols = [s.padded(max_faults) for s in schedules]
    return tuple(np.stack([c[i] for c in cols]) for i in range(4))
