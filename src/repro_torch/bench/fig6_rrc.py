"""Paper Figure 6 — Random Replacement Cache profile (and the LevelDB /
RocksDB profiles of Figs 8-10: their contention *profile* — a mixed-length
critical section around a central lock with short think time — matched on
the lockVM).

    python -m repro_torch.bench.fig6_rrc [--device cuda|cpu]

CS length random in [30, 80) PRNG steps (hash + cache ops), NCS in [0,200);
the ``db`` profile takes a shorter CS.  One SweepSpec per profile, one
engine call (on a GPU, one launch of the lockVM kernel).  Prints the
reference script's rows (``benchmarks/fig6_rrc.py``).
"""

from __future__ import annotations

from repro_torch.sim.workloads import SweepSpec, sweep_curves

from .common import emit, main

THREADS = (1, 2, 4, 8, 16, 32, 64)
LOCKS = ("ticket", "twa", "mcs")


def run(threads=THREADS, runs: int = 3, profile: str = "rrc", *,
        device=None) -> dict:
    cs_rand = (30, 50) if profile == "rrc" else (10, 30)  # db: shorter CS
    spec = SweepSpec(locks=LOCKS, threads=tuple(threads),
                     seeds=tuple(range(1, runs + 1)), cs_rand=cs_rand,
                     ncs_max=200)
    curves = sweep_curves(spec, device=device)
    for lock in LOCKS:
        for t, tp in zip(threads, curves[lock]):
            emit(f"fig6[{profile}]/{lock}/threads={t}", f"{tp:.6f}",
                 "acq_per_cycle")
    emit(f"fig6[{profile}]/twa_over_ticket@64",
         f"{curves['twa'][-1] / curves['ticket'][-1]:.3f}", "paper: >1")
    return curves


if __name__ == "__main__":
    main(run, "lockVM fig6 (random replacement cache profile)")
