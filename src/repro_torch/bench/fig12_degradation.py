"""Degradation under preemption — throughput + handover latency vs
preemption count, via the SweepSpec fault axes.

    python -m repro_torch.bench.fig12_degradation [--device cuda|cpu] [--smoke]

The paper's ticket-lock pathology (Sec 2): a preempted thread whose ticket
is next stalls every later waiter behind it; TWA's waiting array lets far
waiters absorb the stall off the grant word, and the fissile/timed variants
shed or abandon the stalled slot entirely.  This suite injects 0..N
deterministic preemption windows per run (``preempt_faults`` axis) and
reports, per lock, the median throughput and handover latency at each
preemption level plus the throughput retained at the highest level
relative to the fault-free cell.  Prints the reference script's rows
(``benchmarks/fig12_degradation.py``).

Emitted under the ``fig12deg/`` prefix (``fig11_locktorture`` already owns
``fig12/``).  Two hard checks ride along:

- the zero-preemption column of the fault sweep must be bit-identical to a
  separate ``faults=None`` sweep (padded all-F_NONE fault rows are no-ops;
  on a GPU this holds the lockVM kernel's fault path to its no-fault path);
- ``fissile-twa`` must retain at least as much of its fault-free
  throughput as plain ``ticket`` at the highest preemption level.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from repro_torch.sim.workloads import SweepSpec, run_sweep

from .common import emit, main

LOCKS = ("ticket", "twa", "fissile-twa", "twa-timo")
PREEMPTS = (0, 2, 4, 8, 16)
N_THREADS = 8


def _median_by(results, locks, preempts, key):
    """{(lock, preempts): median-over-seeds of results[key]}."""
    out = {}
    for lock in locks:
        for p in preempts:
            vals = [r[key] for r in results
                    if r["lock"] == lock and r["preempt_faults"] == p]
            out[lock, p] = float(np.median(vals))
    return out


def run(smoke: bool = False, *, device=None) -> dict:
    preempts = (0, 4, 16) if smoke else PREEMPTS
    runs = 2 if smoke else 3
    horizon = 40_000 if smoke else 120_000
    spec = SweepSpec(locks=LOCKS, threads=N_THREADS,
                     seeds=tuple(range(1, runs + 1)), cs_work=20,
                     ncs_max=50, horizon=horizon, max_events=2 * horizon,
                     preempt_faults=preempts, preempt_cost=2048,
                     fault_evt_span=horizon // 8)
    results = run_sweep(spec, device=device)

    # Zero-preemption cells ran with padded all-F_NONE fault rows; they
    # must be bit-identical to the dedicated faults=None call.
    clean = run_sweep(replace(spec, preempt_faults=0), device=device)
    zero = [r for r in results if r["preempt_faults"] == 0]
    assert len(zero) == len(clean)
    for a, b in zip(clean, zero):
        assert np.array_equal(a["mem"], b["mem"]), (a["lock"], a["seed"])
        assert a["throughput"] == b["throughput"]
    emit("fig12deg/zero_fault_bitidentical", "1",
         f"{len(zero)} cells vs faults=None")

    thr = _median_by(results, LOCKS, preempts, "throughput")
    hand = _median_by(results, LOCKS, preempts, "avg_handover")
    for lock in LOCKS:
        for p in preempts:
            emit(f"fig12deg/{lock}/preempts={p}", f"{thr[lock, p]:.6f}",
                 f"handover={hand[lock, p]:.1f}")

    p_max = preempts[-1]
    retained = {lock: thr[lock, p_max] / thr[lock, 0] for lock in LOCKS}
    for lock in LOCKS:
        emit(f"fig12deg/retained/{lock}", f"{retained[lock]:.3f}",
             f"preempts={p_max} vs 0")
    emit("fig12deg/fissile_over_ticket_retained",
         f"{retained['fissile-twa'] / retained['ticket']:.3f}",
         "graceful degradation, expect >=1")
    assert retained["fissile-twa"] >= retained["ticket"], (
        f"fissile-twa retained {retained['fissile-twa']:.3f} < "
        f"ticket {retained['ticket']:.3f} at preempts={p_max}")
    return {"throughput": thr, "handover": hand, "retained": retained}


if __name__ == "__main__":
    main(run, "lockVM fig12deg (degradation under preemption)")
