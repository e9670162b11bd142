"""Paper Figure 3 — MutexBench: aggregate lock throughput vs thread count.

    python -m repro_torch.bench.fig3_mutexbench [--device cuda|cpu]

CS = 4 PRNG steps, NCS uniform in [0,200) steps (paper §4.2), on the lockVM.
Alongside each throughput point the figure reports the contended acquire
tail (lat_p50/p99/p999, cycles).  Prints the same ``name,value,derived``
CSV rows as the reference script (``benchmarks/fig3_mutexbench.py``) over
the locks and thread counts the program generators accept: ``twa-timo``'s
generator caps it at 32 threads (its waiting ring has 32 slots), so its
cells stop there while every other lock runs to 64.  The whole figure is
ONE engine call (:func:`repro_torch.sim.run_sweeps`) — on a GPU, one
launch of the lockVM kernel.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.sim import SIM_LOCKS, SweepSpec, run_sweeps
from repro_torch.sim.programs import TIMO_RING

from .common import emit

THREADS = (1, 2, 4, 8, 16, 32, 64)
LOCKS = tuple(SIM_LOCKS)


def thread_counts(lock: str, threads=THREADS) -> tuple:
    """The thread counts of ``threads`` that ``lock``'s generator accepts."""
    if lock == "twa-timo":
        return tuple(t for t in threads if t <= TIMO_RING)
    return tuple(threads)


def run(locks=LOCKS, threads=THREADS, runs: int = 3, *, horizon=None,
        device=None) -> dict:
    kw = dict(seeds=tuple(range(1, runs + 1)), cs_work=4, ncs_max=200,
              collect_latency=True)
    if horizon is not None:
        kw["horizon"] = horizon
    groups: dict[tuple, list] = {}
    for lock in locks:
        groups.setdefault(thread_counts(lock, threads), []).append(lock)
    specs = [SweepSpec(locks=tuple(lks), threads=ts, **kw)
             for ts, lks in groups.items()]
    by_cell = {}
    for results in run_sweeps(specs, device=device):
        for r in results:
            by_cell.setdefault((r["lock"], r["n_threads"]), []).append(r)
    curves = {}
    for lock in locks:
        curves[lock] = []
        for t in thread_counts(lock, threads):
            rs = by_cell[(lock, t)]
            tp = float(np.median([r["throughput"] for r in rs]))
            curves[lock].append(tp)
            emit(f"fig3/{lock}/threads={t}", f"{tp:.6f}", "acq_per_cycle")
            for col in ("lat_p50", "lat_p99", "lat_p999"):
                v = float(np.median([r[col] for r in rs]))
                emit(f"fig3/{lock}/threads={t}/{col}", f"{v:.0f}", "cycles")
    if {"ticket", "twa", "mcs"} <= set(curves) and max(threads) in \
            thread_counts("ticket", threads):
        t_hi = {k: curves[k][-1] for k in ("ticket", "twa", "mcs")}
        emit(f"fig3/twa_over_ticket@{max(threads)}",
             f"{t_hi['twa'] / t_hi['ticket']:.3f}", "paper: >>1")
        emit(f"fig3/twa_over_mcs@{max(threads)}",
             f"{t_hi['twa'] / t_hi['mcs']:.3f}", "paper: >=1")
    return curves


def main() -> None:
    ap = argparse.ArgumentParser(description="lockVM fig3 (MutexBench)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--horizon", type=int, default=None)
    opts = ap.parse_args()
    run(horizon=opts.horizon, device=opts.device)


if __name__ == "__main__":
    main()
