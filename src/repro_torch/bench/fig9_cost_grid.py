"""Figure 9 (new) — coherence-cost sensitivity grid (C_INV x C_XFER).

    python -m repro_torch.bench.fig9_cost_grid [--device cuda|cpu] [--smoke]

The paper's causal story (§2, Fig 1) is that ticket locks collapse because a
release store pays the *invalidation diameter*: C_INV per camped sharer.
This suite quantifies that argument by sweeping the cost model itself: at
C_INV = 0 the diameter is free and ticket's collapse must vanish; as C_INV
grows, TWA's advantage (bounded spinner count) must widen monotonically.
C_XFER (dirty-line transfer) scales every handover equally, so it shifts
absolute throughput but barely moves the TWA/ticket ratio — separating the
two effects is the point of the grid.

The whole grid — locks x C_INV x C_XFER x seeds — is one SweepSpec on the
``costs`` axis and therefore ONE engine call (on a GPU, one launch of the
lockVM kernel).

A second cell sweeps the ``sem_permits`` axis (the mutex→semaphore
continuum): one twa-sem SweepSpec over permits, asserting throughput grows
monotonically-ish with capacity — permits=1 is a FIFO mutex, larger K
admits K concurrent critical sections.  Runs in ``--smoke`` too.  Prints
the reference script's rows (``benchmarks/fig9_cost_grid.py``).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from repro_torch.sim import DEFAULT_COSTS
from repro_torch.sim.workloads import SweepSpec, run_sweep

from .common import emit, main

LOCKS = ("ticket", "twa", "mcs")
C_INVS = (0, 6, 12, 24, 48)
C_XFERS = (30, 90, 180)
N_THREADS = 32
SEEDS = (1, 2, 3)
HORIZON = 500_000

SMOKE_C_INVS = (0, 24)
SMOKE_C_XFERS = (90,)
SMOKE_SEEDS = (1,)
SMOKE_HORIZON = 150_000

SEM_PERMITS = (1, 2, 4, 8)
SEM_THREADS = 32


def run_sem_permits(smoke: bool = False, *, device=None) -> dict[int, float]:
    """The mutex→semaphore continuum as ONE SweepSpec on ``sem_permits``."""
    horizon = SMOKE_HORIZON if smoke else HORIZON
    seeds = SMOKE_SEEDS if smoke else SEEDS
    spec = SweepSpec(locks="twa-sem", threads=SEM_THREADS, seeds=seeds,
                     sem_permits=SEM_PERMITS, horizon=horizon)
    results = run_sweep(spec, device=device)
    tput = {}
    for permits in SEM_PERMITS:
        vals = [r["throughput"] for r in results
                if r["sem_permits"] == permits]
        tput[permits] = float(np.median(vals))
        emit(f"fig9/twa-sem/permits={permits}", f"{tput[permits]:.6f}",
             "acq_per_cycle")
    emit("fig9/sem_scaling",
         f"{tput[SEM_PERMITS[-1]] / tput[SEM_PERMITS[0]]:.2f}x",
         "mutex->semaphore continuum (permits "
         f"{SEM_PERMITS[0]}->{SEM_PERMITS[-1]})")
    assert tput[SEM_PERMITS[-1]] > 1.5 * tput[SEM_PERMITS[0]], tput
    assert all(tput[b] > 0.8 * tput[a]  # monotone up to seed noise
               for a, b in zip(SEM_PERMITS, SEM_PERMITS[1:])), tput
    return tput


def run(smoke: bool = False, *, device=None) -> dict:
    c_invs = SMOKE_C_INVS if smoke else C_INVS
    c_xfers = SMOKE_C_XFERS if smoke else C_XFERS
    seeds = SMOKE_SEEDS if smoke else SEEDS
    grid = tuple(replace(DEFAULT_COSTS, C_INV=ci, C_XFER=cx)
                 for ci in c_invs for cx in c_xfers)
    spec = SweepSpec(locks=LOCKS, threads=N_THREADS, seeds=seeds, costs=grid,
                     horizon=SMOKE_HORIZON if smoke else HORIZON)
    results = run_sweep(spec, device=device)
    tput: dict[tuple, float] = {}
    for lock in LOCKS:
        for co in grid:
            vals = [r["throughput"] for r in results
                    if r["lock"] == lock and r["costs"] == co]
            tput[lock, co.C_INV, co.C_XFER] = float(np.median(vals))
            emit(f"fig9/{lock}/cinv={co.C_INV}/cxfer={co.C_XFER}",
                 f"{tput[lock, co.C_INV, co.C_XFER]:.6f}", "acq_per_cycle")
    ratios = {}
    for cx in c_xfers:
        for ci in c_invs:
            ratio = tput["twa", ci, cx] / tput["ticket", ci, cx]
            ratios[ci, cx] = ratio
            emit(f"fig9/twa_over_ticket/cinv={ci}/cxfer={cx}",
                 f"{ratio:.3f}", "paper: grows with C_INV")
        emit(f"fig9/ratio_span/cxfer={cx}",
             f"{ratios[c_invs[0], cx]:.3f}->{ratios[c_invs[-1], cx]:.3f}",
             "invalidation-diameter sensitivity")
    sem = run_sem_permits(smoke, device=device)
    return {"throughput": tput, "ratios": ratios, "sem_permits": sem}


if __name__ == "__main__":
    main(run, "lockVM fig9 (coherence-cost grid)")
