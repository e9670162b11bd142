"""Paper Figure 7 — libslock stress_latency: fixed CS = 200 delay-loop
iterations, NCS = 5000 (scaled 1:25 on the lockVM to keep sim time bounded:
CS=20, fixed outside work 20, random NCS up to 480).

    python -m repro_torch.bench.fig7_stress_latency [--device cuda|cpu]

One SweepSpec, one engine call (on a GPU, one launch of the lockVM kernel).
This is the latency figure, so the sweep runs with ``collect_latency=True``
and reports the per-acquisition tail — p50/p99/p999 of the TSTART→ACQ time
from the engine's log2 histogram — alongside throughput.  The fixed
``outside_work`` leg guarantees off-lock time between iterations, matching
stress_latency's deterministic delay loop rather than leaving the arrival
rate entirely to the random NCS draw.  Prints the reference script's rows
(``benchmarks/fig7_stress_latency.py``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.sim.workloads import SweepSpec, run_sweep

from .common import emit, main

THREADS = (1, 2, 4, 8, 16, 32, 64)
LOCKS = ("ticket", "twa", "mcs")
OUTSIDE_WORK = 20


def run(threads=THREADS, runs: int = 3, *, device=None) -> dict:
    spec = SweepSpec(locks=LOCKS, threads=tuple(threads),
                     seeds=tuple(range(1, runs + 1)), cs_work=20,
                     outside_work=OUTSIDE_WORK, cs_rand=None, ncs_max=480,
                     horizon=1_000_000, collect_latency=True)
    results = run_sweep(spec, device=device)
    by_cell = {}
    for r in results:
        by_cell.setdefault((r["lock"], r["n_threads"]), []).append(r)
    curves = {lock: [] for lock in LOCKS}
    for lock in LOCKS:
        for t in threads:
            rs = by_cell[(lock, t)]
            tput = float(np.median([r["throughput"] for r in rs]))
            p50 = float(np.median([r["lat_p50"] for r in rs]))
            p99 = float(np.median([r["lat_p99"] for r in rs]))
            p999 = float(np.median([r["lat_p999"] for r in rs]))
            emit(f"fig7/{lock}/threads={t}", f"{tput:.6f}", "acq_per_cycle")
            emit(f"fig7/{lock}/threads={t}/lat_p50", f"{p50:.0f}", "cycles")
            emit(f"fig7/{lock}/threads={t}/lat_p99", f"{p99:.0f}", "cycles")
            emit(f"fig7/{lock}/threads={t}/lat_p999", f"{p999:.0f}",
                 "cycles")
            curves[lock].append(tput)
    return curves


if __name__ == "__main__":
    main(run, "lockVM fig7 (stress_latency)")
