"""Cheap per-batch coverage feedback for steered fuzzing.

The batch oracle (:mod:`batch_oracle`, either implementation) can return
per-case execution counters at near-zero cost: opcode executions, taken
branches per branch kind, failed-spin parks per spin kind, store commits,
spin wakeups, and RMW sign-flip (int32 wrap) events.  This module turns
those counters into **coverage signatures** — small hashable tuples coarse
enough to collide for boringly-similar cases and fine enough to separate a
new interleaving class — and accumulates them into a run-level
:class:`CoverageMap`.

A signature is::

    (lock, active-invariant-classes, exit_reason,
     bucketed op histogram, bucketed taken-branch histogram,
     bucketed spin-park histogram, bucketed (commits, wakes, wraps),
     bucketed (preempt, spurious, abort) fault counts)

The fault counts are STATIC — read off the scenario's scheduled fault
rows, not off runtime counters — so the signature is identical no matter
which execution path ran the case, and a fault-laden variant of a known
case class is exactly one new signature away from its clean twin.

where every raw count is squashed through log2-ish buckets
(:data:`BUCKETS`), AFL-style: the difference between 33 and 40 wakeups is
noise, the difference between 0 and 1 wrap events is a new behaviour.  The
steering loop in ``runner.steer`` promotes a case into the mutation corpus
exactly when its signature is new to the map.

The run-level map additionally keeps raw totals — opcode execution,
taken branches, the lock x invariant-class matrix, and the
wrap/collision-event histogram — and serializes to JSON for the nightly
coverage-report artifact.
"""

from __future__ import annotations

import json
from collections import Counter

import numpy as np

from .. import isa
from ..faults import F_ABORT, F_PREEMPT, F_SPURIOUS
from .batch_oracle import N_BRANCH_KINDS, N_SPIN_KINDS
from .invariants import active_classes, scenario_fault_schedule

# Log2-ish bucket edges: count -> np.digitize(count, BUCKETS) so
# 0->0, 1->1, 2->2, 3->3, 4..7->4, 8..15->5, 16..31->6, 32..127->7, 128+->8.
BUCKETS = np.array([1, 2, 3, 4, 8, 16, 32, 128])

_BRANCH_NAMES = [isa.OP_NAMES[isa.BEQ + k] for k in range(N_BRANCH_KINDS)]
# spin-kind index: 0..3 = SPIN_EQ..SPIN_NEI, last = SPIN_GE (matches the
# batch oracle's skind mapping)
_SPIN_NAMES = ([isa.OP_NAMES[isa.SPIN_EQ + k]
                for k in range(N_SPIN_KINDS - 1)] + ["SPIN_GE"])


def bucketize(arr) -> tuple:
    """Squash raw counts through the log2-ish buckets; hashable output."""
    return tuple(np.digitize(np.asarray(arr), BUCKETS).tolist())


def fault_counts(scenario) -> tuple[int, int, int]:
    """Static ``(preempt, spurious, abort)`` counts of the scheduled faults."""
    sched = scenario_fault_schedule(scenario)
    if sched is None:
        return (0, 0, 0)
    return (int((sched.kind == F_PREEMPT).sum()),
            int((sched.kind == F_SPURIOUS).sum()),
            int((sched.kind == F_ABORT).sum()))


def case_signature(scenario, op_row, branch_row, spin_row,
                   commits, wakes, wraps, exit_reason: str) -> tuple:
    """The hashable coverage signature of one case (see module docstring)."""
    return (
        scenario.lock or scenario.kind,
        active_classes(scenario),
        exit_reason,
        bucketize(op_row),
        bucketize(branch_row),
        bucketize(spin_row),
        bucketize([commits, wakes, wraps]),
        bucketize(fault_counts(scenario)),
    )


class CoverageMap:
    """Run-level accumulation of signatures and raw coverage histograms."""

    def __init__(self):
        self.signatures: Counter = Counter()     # signature -> case count
        self.op_totals = np.zeros(isa.N_OPS, np.int64)
        self.branch_totals = np.zeros(N_BRANCH_KINDS, np.int64)
        self.spin_totals = np.zeros(N_SPIN_KINDS, np.int64)
        self.event_totals = Counter()            # commits / wakes / wraps
        self.fault_totals = Counter()            # scheduled preempt/spur/abort
        self.lock_classes: Counter = Counter()   # (lock, class) -> cases
        self.exit_reasons: Counter = Counter()
        self.n_cases = 0

    @property
    def n_signatures(self) -> int:
        return len(self.signatures)

    def add_signature(self, sig: tuple) -> bool:
        """Record one signature; True when it was new to the map."""
        novel = sig not in self.signatures
        self.signatures[sig] += 1
        return novel

    def add_batch(self, scenarios, result) -> list[int]:
        """Fold one ``BatchOracleResult`` (with coverage) into the map.

        Returns the indices whose signature was novel.  Fallback cases
        (zeroed coverage rows) still contribute a — degenerate — signature,
        so a case class that always falls back is only promoted once.
        """
        cov = result.coverage
        assert cov is not None, "run_batch_oracle(collect_coverage=True)?"
        novel = []
        for i, s in enumerate(scenarios):
            exit_reason = (result.traces[i].exit_reason
                           if result.traces is not None else "")
            sig = case_signature(
                s, cov["op_exec"][i], cov["branch_taken"][i],
                cov["spin_sleep"][i], cov["commits"][i], cov["wakes"][i],
                cov["wraps"][i], exit_reason)
            if self.add_signature(sig):
                novel.append(i)
            self.exit_reasons[exit_reason] += 1
            for cls in sig[1]:
                self.lock_classes[(sig[0], cls)] += 1
            pre, spur, ab = fault_counts(s)
            self.fault_totals["preempt"] += pre
            self.fault_totals["spurious"] += spur
            self.fault_totals["abort"] += ab
            self.fault_totals["fault_cases"] += bool(pre or spur or ab)
        self.op_totals += cov["op_exec"].sum(0)
        self.branch_totals += cov["branch_taken"].sum(0)
        self.spin_totals += cov["spin_sleep"].sum(0)
        for key in ("commits", "wakes", "wraps"):
            self.event_totals[key] += int(np.asarray(cov[key]).sum())
        self.n_cases += len(scenarios)
        return novel

    def merge(self, other: "CoverageMap") -> None:
        self.signatures.update(other.signatures)
        self.op_totals += other.op_totals
        self.branch_totals += other.branch_totals
        self.spin_totals += other.spin_totals
        self.event_totals.update(other.event_totals)
        self.fault_totals.update(other.fault_totals)
        self.lock_classes.update(other.lock_classes)
        self.exit_reasons.update(other.exit_reasons)
        self.n_cases += other.n_cases

    def report(self) -> dict:
        """JSON-serializable run-level coverage report."""
        zero_ops = [name for val, name in sorted(isa.OP_NAMES.items())
                    if self.op_totals[val] == 0]
        return {
            "n_cases": self.n_cases,
            "n_signatures": self.n_signatures,
            "opcode_exec": {name: int(self.op_totals[val])
                            for val, name in sorted(isa.OP_NAMES.items())},
            "opcodes_never_executed": zero_ops,
            "branch_taken": {name: int(self.branch_totals[k])
                             for k, name in enumerate(_BRANCH_NAMES)},
            "spin_parks": {name: int(self.spin_totals[k])
                           for k, name in enumerate(_SPIN_NAMES)},
            "events": dict(self.event_totals),
            "scheduled_faults": dict(self.fault_totals),
            "lock_invariant_classes": {
                f"{lock}:{cls}": n
                for (lock, cls), n in sorted(self.lock_classes.items())},
            "exit_reasons": dict(self.exit_reasons),
        }

    def save(self, path) -> None:
        payload = {
            "report": self.report(),
            "signatures": {json.dumps(sig): n
                           for sig, n in self.signatures.items()},
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path) -> "CoverageMap":
        """Rehydrate signatures (report totals are NOT restored — the map
        is reloaded to deduplicate against prior runs, not to re-report
        them)."""
        with open(path) as f:
            payload = json.load(f)

        def detuple(x):
            return tuple(detuple(e) for e in x) if isinstance(x, list) else x

        cm = cls()
        for key, n in payload.get("signatures", {}).items():
            cm.signatures[detuple(json.loads(key))] = n
        return cm


__all__ = ["BUCKETS", "bucketize", "case_signature", "CoverageMap"]
