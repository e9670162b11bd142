"""Lock playground: every algorithm, side by side.

* lockVM throughput + handover latency at several thread counts (clh,
  hemlock and the twa-sem counting semaphore included; ``twa-timo`` only
  up to its generator's 32 threads, where the reference's script raises),
* the semaphore's permit scaling and the waiting-array collision meter,
* host-thread correctness + FIFO check,
* the distributed variants' hot-key telemetry.

The reference's ``examples/lock_playground.py``, with ``--device``::

    PYTHONPATH=src python -m repro_torch.examples.lock_playground [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import threading
import time

from ..core import (DistributedTicketLock, DistributedTWALock,
                    InMemoryKVStore, LOCK_CLASSES, make_lock)
from ..device import resolve_device
from ..sim.programs import SIM_LOCKS, TIMO_RING, read_collision_counters
from ..sim.workloads import SweepSpec, run_contention, run_sweeps

THREADS = (2, 16, 64)
SEM_PERMITS = (1, 2, 4, 8)
WA_SIZES = (16, 128, 2048)
DETAIL_HORIZON = 400_000


def sweep_specs() -> list:
    """The lockVM table's cells: every lock at THREADS, twa-timo at those
    up to TIMO_RING."""
    return [SweepSpec(locks=tuple(lk for lk in SIM_LOCKS if lk != "twa-timo"),
                      threads=THREADS, seeds=1),
            SweepSpec(locks="twa-timo",
                      threads=tuple(t for t in THREADS if t <= TIMO_RING),
                      seeds=1)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # surface the engine's mode='auto' -> <driver> line: the sweeps below
    # don't pin a mode, so the log is the only place the chosen driver shows
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    out = {}

    print("== lockVM: throughput (acq/cycle) and avg handover (cycles) ==")
    print(f"{'lock':>12} | "
          + " | ".join(f"T={t:<2}  tput   hand" for t in THREADS))
    # every (lock, T) cell in one engine call; twa-timo's generator gives
    # each thread a ring slot, so it stops at TIMO_RING threads
    results = {(r["lock"], r["n_threads"]): r
               for rs in run_sweeps(sweep_specs(), device=device)
               for r in rs}
    out["sweep"] = {}
    for lock in SIM_LOCKS:
        cells = []
        for t in THREADS:
            r = results.get((lock, t))
            if r is None:
                cells.append(f"{'n/a':>14}")
                continue
            out["sweep"][lock, t] = (r["throughput"], r["avg_handover"])
            cells.append(f"{r['throughput']:.5f} {r['avg_handover']:6.0f}")
        print(f"{lock:>12} | " + " | ".join(cells))

    print("\n== twa-sem: counting-semaphore permit scaling (T=32) ==")
    out["sem"] = {}
    for permits in SEM_PERMITS:
        r = run_contention("twa-sem", 32, sem_permits=permits,
                           horizon=DETAIL_HORIZON, device=device)
        out["sem"][permits] = r["throughput"]
        print(f"  permits={permits}: tput={r['throughput']:.5f} acq/cycle")

    print("\n== waiting-array collisions (twa, T=32, 4 locks, paper §3) ==")
    out["collisions"] = {}
    for wa_size in WA_SIZES:
        r = run_contention("twa", 32, n_locks=4, wa_size=wa_size,
                           count_collisions=True, horizon=DETAIL_HORIZON,
                           device=device)
        wakes, futile = read_collision_counters(r["mem"], r["layout"])
        rate = futile.sum() / max(wakes.sum(), 1)
        out["collisions"][wa_size] = (int(futile.sum()), int(wakes.sum()))
        print(f"  wa_size={wa_size:>4}: collision rate={rate:.3f} "
              f"({futile.sum()} futile / {wakes.sum()} wakeups)")

    print("\n== host threads: correctness under contention ==")
    out["host_threads"] = {}
    for kind in sorted(LOCK_CLASSES):
        lk = make_lock(kind)
        total = [0]

        def w():
            for _ in range(500):
                lk.acquire()
                total[0] += 1
                lk.release()

        ts = [threading.Thread(target=w) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        out["host_threads"][kind] = total[0]
        ok = "ok" if total[0] == 2000 else f"LOST {2000 - total[0]}"
        print(f"  {kind:>12}: {total[0]} acquisitions ({ok})")

    print("\n== distributed locks over a KV store: hot-key reads ==")
    out["distributed"] = {}
    for cls in (DistributedTicketLock, DistributedTWALock):
        store = InMemoryKVStore()
        lk = cls(store, "demo")

        def worker():
            lk.acquire()
            time.sleep(0.002)
            lk.release()

        ts = [threading.Thread(target=worker) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        grant = store.read_counts.get("demo/grant", 0)
        slots = sum(v for k, v in store.read_counts.items() if "twa/wa" in k)
        out["distributed"][cls.name] = (grant, slots)
        print(f"  {cls.name:>12}: grant-key reads={grant:4d}  slot reads="
              f"{slots:4d}   <- TWA parks far waiters on hashed slots")
    return out


if __name__ == "__main__":
    main()
