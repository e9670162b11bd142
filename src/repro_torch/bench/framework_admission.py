"""Framework-level admission benchmark — the paper's claim at the layer where
this framework deploys it.

    python -m repro_torch.bench.framework_admission [--device cuda|cpu] [--smoke]

N client threads contend for a 1-lane admission gate, one run per registered
``LockGate`` kind (``make_gate``): plain single-tier ``ticket`` polls the hot
grant counter globally, ``twa`` bounds it with two-tier waiting, and the
compositions ride along (``fissile-twa`` fast-window, ``twa-rw`` metadata
reads).  We report polls on the hot counter per handover — the
coordination-layer analogue of the invalidation diameter.

The same admission geometry is then swept on the lockVM through one
``SweepSpec`` (one engine call: on a GPU, one launch of the lockVM kernel;
persisting into the results store when ``--results`` /
``REPRO_RESULTS_STORE`` is set), so the framework-level numbers land next to
their simulated counterparts under the ``admission/sim/*`` rows.  The
distributed-lock variant over the KV store (per-key read telemetry) closes
the figure.  Prints the reference script's rows
(``benchmarks/framework_admission.py``).
"""

from __future__ import annotations

import threading

import numpy as np

from repro_torch.core import (DistributedTWALock, DistributedTicketLock,
                              InMemoryKVStore)
from repro_torch.serve.admission import GATES, make_gate
from repro_torch.sim.workloads import SweepSpec, run_sweep

from .common import emit, main

N_CLIENTS = 24
GATE_KINDS = tuple(GATES)          # ticket, twa, fissile-twa, twa-rw
SIM_LOCKS = ("ticket", "twa", "fissile-twa", "twa-rw")


def _gate_run(kind: str, n_clients: int = N_CLIENTS,
              hold_s: float = 0.002) -> dict:
    """One admission run through a pluggable gate: every client draws its own
    ticket, waits for the lane, holds it for ``hold_s`` (so a real queue forms
    and the waiters' polling shows up), and advances the grant itself — the
    gate's counters are the only bookkeeping."""
    import time

    gate = make_gate(kind, 1)
    done = []
    order_lock = threading.Lock()

    def client():
        tx = gate.draw()
        gate.wait(tx, timeout_s=60)   # blocks until this ticket holds the lane
        if kind == "twa-rw":
            gate.read_metadata(gate.queue_depth)
        with order_lock:
            done.append(tx)
        time.sleep(hold_s)
        gate.advance()

    ths = [threading.Thread(target=client) for _ in range(n_clients)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(30)
    st = gate.poll_stats()
    st["fifo_ok"] = done == sorted(done)
    return st


def _sim_sweep(smoke: bool, device=None) -> dict:
    """The same geometry on the lockVM: 1 lock, N_CLIENTS threads, short CS.
    Cells persist via the ``REPRO_RESULTS_STORE`` hook (``--results``)."""
    spec = SweepSpec(locks=SIM_LOCKS, threads=(8, N_CLIENTS),
                     seeds=(1,) if smoke else (1, 2, 3),
                     cs_work=4, ncs_max=16,
                     horizon=150_000 if smoke else 500_000)
    by_cell = {}
    for r in run_sweep(spec, device=device):
        by_cell.setdefault((r["lock"], r["n_threads"]), []).append(
            r["throughput"])
    out = {}
    for (lock, t), tps in sorted(by_cell.items()):
        tp = float(np.median(tps))
        out[(lock, t)] = tp
        emit(f"admission/sim/{lock}/threads={t}", f"{tp:.6f}",
             "acq_per_cycle")
    return out


def _dist_run(cls, n_workers: int = 12, hold_s: float = 0.004) -> dict:
    """All workers contend at once; the holder keeps the lock for `hold_s`
    so a real queue forms and waiting-policy differences become visible in
    the store's per-key read telemetry."""
    import time

    store = InMemoryKVStore()
    lock = cls(store, "bench")
    order = []
    barrier = threading.Barrier(n_workers)

    def worker(i):
        barrier.wait()
        lock.acquire()
        order.append(i)
        time.sleep(hold_s)
        lock.release()

    ths = [threading.Thread(target=worker, args=(i,)) for i in range(n_workers)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60)
    grant_reads = store.read_counts.get("bench/grant", 0)
    slot_reads = sum(v for k, v in store.read_counts.items()
                     if k.startswith("twa/wa/"))
    return {"grant_reads": grant_reads, "slot_reads": slot_reads,
            "acquisitions": len(order)}


def run(smoke: bool = False, *, device=None) -> dict:
    out = {}
    for kind in GATE_KINDS:
        st = _gate_run(kind)
        per_handover = st["grant_polls"] / N_CLIENTS
        emit(f"admission/{kind}/grant_polls_per_handover",
             f"{per_handover:.1f}", f"fifo_ok={st['fifo_ok']}")
        if kind == "twa":
            emit("admission/twa/slot_polls", st["slot_polls"],
                 f"long_term_entries={st['long_term_entries']}")
        if kind == "twa-rw":
            emit("admission/twa-rw/metadata_reads", st["metadata_reads"],
                 f"reader_overlap_max={st.get('reader_overlap_max', 0)}")
        out[kind] = st
    ratio = (out["ticket"]["grant_polls"]
             / max(out["twa"]["grant_polls"], 1))
    emit("admission/grant_polls_ticket_over_twa", f"{ratio:.2f}",
         "paper analogue: >1 (two-tier bounds hot-counter polling)")
    out["sim"] = _sim_sweep(smoke, device)
    for cls in (DistributedTicketLock, DistributedTWALock):
        st = _dist_run(cls)
        emit(f"admission/dist/{cls.name}/grant_key_reads",
             st["grant_reads"], f"slot_reads={st['slot_reads']}")
        out[cls.name] = st
    ratio = (out["dist-ticket"]["grant_reads"]
             / max(out["dist-twa"]["grant_reads"], 1))
    emit("admission/dist/hot_key_load_ratio_ticket_over_twa",
         f"{ratio:.2f}", "paper analogue: >1 (TWA bounds hot-key polling)")
    return out


if __name__ == "__main__":
    main(run, "framework admission (gates, lockVM, distributed locks)")
