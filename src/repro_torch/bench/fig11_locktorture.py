"""Paper Figures 11/12 — Linux locktorture, high (N=20) and moderate
(N=400) contention: CS = 20 PRNG steps, NCS uniform in [0,N].

    python -m repro_torch.bench.fig11_locktorture [--device cuda|cpu]

One SweepSpec per contention level, one engine call each (on a GPU, one
launch of the lockVM kernel).  Prints the reference script's rows
(``benchmarks/fig11_locktorture.py``) under the ``fig11/`` and ``fig12/``
prefixes.
"""

from __future__ import annotations

from repro_torch.sim.workloads import SweepSpec, sweep_curves

from .common import emit, main

THREADS = (1, 2, 4, 8, 16, 32, 64)
LOCKS = ("ticket", "twa", "mcs")


def run(threads=THREADS, runs: int = 3, *, device=None) -> dict:
    curves = {}
    for fig, ncs in (("fig11", 20), ("fig12", 400)):
        spec = SweepSpec(locks=LOCKS, threads=tuple(threads),
                         seeds=tuple(range(1, runs + 1)), cs_work=20,
                         ncs_max=ncs)
        fig_curves = sweep_curves(spec, device=device)
        for lock in LOCKS:
            for t, tp in zip(threads, fig_curves[lock]):
                emit(f"{fig}/{lock}/threads={t}", f"{tp:.6f}", f"ncs_max={ncs}")
            curves[f"{fig}/{lock}"] = fig_curves[lock]
        emit(f"{fig}/twa_over_ticket@64",
             f"{curves[f'{fig}/twa'][-1] / curves[f'{fig}/ticket'][-1]:.3f}",
             "paper: >1 at high T")
    return curves


if __name__ == "__main__":
    main(run, "lockVM fig11/fig12 (locktorture)")
