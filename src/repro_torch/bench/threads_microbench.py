"""Real-thread microbenchmark (§4.2 analogue on host threads).

    python -m repro_torch.bench.threads_microbench

CPython's GIL hides most cache-coherence effects, so this benchmark validates
deployment-grade behaviour (correctness under real preemption, comparable
throughput across algorithms, FIFO fairness) rather than the scalability
curve, which the lockVM reproduces.  Reported per lock algorithm: aggregate
acquisitions over a fixed wall-clock window and the max-min fairness spread.
Prints the reference script's rows (``benchmarks/threads_microbench.py``);
the port's host locks (``repro_torch.core.make_lock``) run on the host's
threads, so ``device`` is taken only for ``bench.run``'s sake.
"""

from __future__ import annotations

import threading
import time

from repro_torch.core import make_lock
from repro_torch.sim.workloads import SweepSpec

from .common import emit, main

# Grid declared with the same SweepSpec the lockVM figures use; cells are
# executed on host threads (make_lock) instead of the simulator.
SPEC = SweepSpec(locks=("ticket", "twa", "mcs", "anderson"),
                 threads=(1, 4, 16), seeds=(1,))
WINDOW_S = 0.4


def _contend(lock, n_threads: int, window_s: float = WINDOW_S):
    counts = [0] * n_threads
    stop = time.perf_counter() + window_s
    barrier = threading.Barrier(n_threads)

    def worker(i):
        barrier.wait()
        x = 0
        while time.perf_counter() < stop:
            lock.acquire()
            x += 1          # critical section
            counts[i] += 1
            lock.release()

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return counts


def run(*, device=None) -> dict:
    out = {}
    for cell in SPEC.cells():
        counts = _contend(make_lock(cell.lock), cell.n_threads)
        total = sum(counts)
        spread = (max(counts) - min(counts)) / max(total, 1)
        emit(f"threads/{cell.lock}/threads={cell.n_threads}", total,
             f"fairness_spread={spread:.3f}")
        out[(cell.lock, cell.n_threads)] = total
    return out


if __name__ == "__main__":
    main(run, "host-thread lock microbenchmark")
