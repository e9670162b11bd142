"""Paper Figure 2 — Inter-Lock Interference.

    python -m repro_torch.bench.fig2_interlock_interference [--device cuda|cpu]

64 threads, pool of L locks picked at random per iteration; reports the
throughput of shared-array TWA divided by an idealized private-array-per-lock
TWA.  The paper's worst case penalty is < 8%.  Prints the reference
script's rows (``benchmarks/fig2_interlock_interference.py``); each pool
size is one engine call over the (private_arrays × seeds) axes.  At 64
locks a private-array cell holds 284,672 memory words, more than one
block's shared memory, so on a GPU that launch keeps every cell's state in
global scratch.
"""

from __future__ import annotations

from repro_torch.sim.workloads import fig2_interlock_interference

from .common import emit, main

# The paper sweeps 1..8192 on hardware; the lockVM covers 1..64 (the
# reference script's pools).  The idealized private-array variant's memory
# grows linearly in the pool.
POOLS = (1, 8, 64)


def run(pools=POOLS, *, device=None) -> dict:
    ratios = fig2_interlock_interference(pools, runs=2, horizon=400_000,
                                         device=device)
    out = {}
    for n, ratio in zip(pools, ratios):
        emit(f"fig2/locks={n}", f"{ratio:.4f}", "shared_over_private")
        out[n] = ratio
    emit("fig2/worst_penalty", f"{1 - min(ratios):.4f}", "paper: <0.08")
    return out


if __name__ == "__main__":
    main(run, "lockVM fig2 (inter-lock interference)")
