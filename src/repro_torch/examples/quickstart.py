"""Quickstart: the TWA lock three ways.

1. The lock itself (host threads) — paper Listing 1, deployable.
2. The lockVM reproduction — the paper's MutexBench curve shape.
3. The framework — a few training steps of an assigned architecture with
   the TWA-guarded data pipeline.

The reference's ``examples/quickstart.py``, with ``--device``::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import threading

import torch

from ..configs import get_config
from ..core import make_lock
from ..data import Prefetcher, SyntheticLM
from ..device import resolve_device
from ..optim import AdamW
from ..sim.workloads import median_throughput
from ..train.train_step import TrainOptions, build_train_step, make_state

LOCKS = ("ticket", "twa", "mcs")
THREADS = (1, 8, 32)
TRAIN_ARCH, TRAIN_STEPS, BATCH, SEQ = "deepseek-7b", 5, 4, 32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # -- 1. the lock ----------------------------------------------------------
    lock = make_lock("twa")      # or "ticket", "mcs", "tkt-dual", "twa-id"
    counter = [0]

    def bump(n):
        for _ in range(n):
            lock.acquire()
            counter[0] += 1
            lock.release()

    threads = [threading.Thread(target=bump, args=(1000,)) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if counter[0] != 4000:
        raise AssertionError(f"counter={counter[0]}, expected 4000")
    print(f"[1] TWA lock: 4 threads x 1000 increments -> counter="
          f"{counter[0]} (long-term entries: {lock.long_term_entries})")

    # -- 2. the paper's curve on the lockVM -----------------------------------
    print("[2] MutexBench (lockVM, acquisitions/cycle):")
    print(f"    {'T':>4} {'ticket':>10} {'twa':>10} {'mcs':>10}")
    mutexbench = {}
    for T in THREADS:
        row = [median_throughput(k, T, runs=1, device=device) for k in LOCKS]
        mutexbench[T] = dict(zip(LOCKS, row))
        print(f"    {T:>4} {row[0]:>10.6f} {row[1]:>10.6f} {row[2]:>10.6f}")
    print("    (ticket wins small T; TWA >= MCS at large T — paper Fig. 3)")

    # -- 3. the framework -----------------------------------------------------
    cfg = get_config(TRAIN_ARCH).reduced()
    optimizer = AdamW(lr=1e-3)
    step_fn = build_train_step(cfg, optimizer, TrainOptions())
    state = make_state(cfg, optimizer, 0, device=device)
    src = SyntheticLM(cfg, batch=BATCH, seq=SEQ)
    losses = []
    with Prefetcher(src) as pf:      # prefetch thread guarded by a TWA lock
        for _ in range(TRAIN_STEPS):
            step, batch = pf.get()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            print(f"[3] train step {step}: loss {losses[-1]:.4f}")
    print("done.")
    return {"counter": counter[0],
            "long_term_entries": lock.long_term_entries,
            "mutexbench": mutexbench, "losses": losses}


if __name__ == "__main__":
    main()
