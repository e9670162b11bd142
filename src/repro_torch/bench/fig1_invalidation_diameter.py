"""Paper Figure 1 — Invalidation Diameter.

    python -m repro_torch.bench.fig1_invalidation_diameter [--device cuda|cpu]

One writer FetchAdds a shared word while T-1 readers poll it; writer
throughput degrades as the reader count (the number of caches the store must
invalidate) grows.  Reproduced on the lockVM coherence model: every reader
count is one cell of one engine call (on a GPU, one launch of the lockVM
kernel).  Prints the reference script's rows
(``benchmarks/fig1_invalidation_diameter.py``).

Claim validated: writer ops/cycle decreases monotonically with readers.
"""

from __future__ import annotations

from repro_torch.sim.workloads import fig1_invalidation_diameter

from .common import emit, main

READERS = (0, 1, 3, 7, 15, 31, 63)


def run(*, device=None) -> dict:
    tp = fig1_invalidation_diameter(READERS, device=device)
    out = {}
    for r, t in zip(READERS, tp):
        emit(f"fig1/readers={r}", f"{t:.6f}", "writer_ops_per_cycle")
        out[r] = t
    drop = tp[-1] / tp[0] if tp[0] else float("nan")
    emit("fig1/throughput_ratio_63r_vs_0r", f"{drop:.4f}",
         "monotone_decreasing=" + str(all(a >= b for a, b in zip(tp, tp[1:]))))
    return out


if __name__ == "__main__":
    main(run, "lockVM fig1 (invalidation diameter)")
