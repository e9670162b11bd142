"""Paper Figure 5 — "throw": fully serialized critical sections, zero
non-critical work (the C++ runtime exception-table lock).

    python -m repro_torch.bench.fig5_throw [--device cuda|cpu]

NCS = 0, CS = 4 PRNG steps; beyond 2 threads the curve recapitulates
MutexBench.  One SweepSpec, one engine call (on a GPU, one launch of the
lockVM kernel).  Fully-serialized CS is the worst-case acquire tail, so the
sweep collects latency and reports lat_p50/p99/p999 per point alongside
throughput.  Prints the reference script's rows
(``benchmarks/fig5_throw.py``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.sim.workloads import SweepSpec, run_sweep

from .common import emit, main

THREADS = (1, 2, 4, 8, 16, 32, 64)
LOCKS = ("ticket", "twa", "mcs")


def run(threads=THREADS, runs: int = 3, *, device=None) -> dict:
    spec = SweepSpec(locks=LOCKS, threads=tuple(threads),
                     seeds=tuple(range(1, runs + 1)), cs_work=4, ncs_max=0,
                     collect_latency=True)
    results = run_sweep(spec, device=device)
    by_cell = {}
    for r in results:
        by_cell.setdefault((r["lock"], r["n_threads"]), []).append(r)
    curves = {}
    for lock in LOCKS:
        curves[lock] = []
        for t in threads:
            rs = by_cell[(lock, t)]
            tp = float(np.median([r["throughput"] for r in rs]))
            curves[lock].append(tp)
            emit(f"fig5/{lock}/threads={t}", f"{tp:.6f}", "acq_per_cycle")
            for col in ("lat_p50", "lat_p99", "lat_p999"):
                v = float(np.median([r[col] for r in rs]))
                emit(f"fig5/{lock}/threads={t}/{col}", f"{v:.0f}", "cycles")
    emit("fig5/twa_over_ticket@64",
         f"{curves['twa'][-1] / curves['ticket'][-1]:.3f}", "paper: >>1")
    return curves


if __name__ == "__main__":
    main(run, "lockVM fig5 (throw)")
