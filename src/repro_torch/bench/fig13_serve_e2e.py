"""Figure 13 — the closed serve↔lockVM loop, end to end.

    python -m repro_torch.bench.fig13_serve_e2e [--device cuda|cpu] [--smoke]

The first figure whose x-axis comes from a *recorded* workload rather than
a synthetic grid:

1. **Record** — a LockTrace of a continuous-batching serve run (from
   ``REPRO_SERVE_TRACE`` if set — a trace saved by either package loads —
   else recorded in-process here).
2. **Compile + sweep** — ``repro_torch.sim.traces`` quantizes the trace
   and replays it through the lockVM over several lock algorithms (on a
   GPU, one launch of the lockVM kernel); the cells persist to the results
   store (``REPRO_RESULTS_STORE`` hook; a local store is used when the
   hook is unset so the loop still closes).
3. **End-to-end** — serve throughput (generated tokens/s) per pluggable
   admission gate, at metadata-read fractions drawn from the trace's own
   windows — the read-mostly axis ``twa-rw`` was built for.
4. **Advise** — ``recommend_lock`` is queried at the trace's coordinates
   and ``ServeEngine(lock="auto")`` instantiates the answer
   (``fig13/loop/auto_gate``).

Prints the reference script's rows (``benchmarks/fig13_serve_e2e.py``).
The model is gemma3-1b reduced, with random weights from a seeded
generator: this figure's subject is the gate and the lockVM, not the
model.  Everything runs on ``device`` (``cuda`` unless given).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serve import ServeEngine
from repro_torch.serve.trace import load_trace
from repro_torch.sim.results import ResultsStore, recommend_lock
from repro_torch.sim.traces import (quantize_trace, trace_sweep_spec,
                                    trace_workload_coords)
from repro_torch.sim.workloads import RESULTS_STORE_ENV, run_sweep

from .common import emit, main

GATES = ("ticket", "twa", "fissile-twa", "twa-rw")
SIM_SWEEP_LOCKS = ("ticket", "twa", "mcs", "fissile-twa", "twa-rw")
TRACE_ENV = "REPRO_SERVE_TRACE"


def _record_trace(cfg, params, *, n_requests: int, max_new: int, device):
    """Record a LockTrace from an in-process continuous-batching run."""
    eng = ServeEngine(cfg, params, lanes=3, max_ctx=96, temperature=0.7,
                      seed=0, record_trace=True, device=device)

    def client(i):
        rng = np.random.default_rng(1000 + i)   # per-thread Generator
        prompt = rng.integers(1, cfg.vocab,
                              size=int(rng.integers(4, 16))).tolist()
        req = eng.submit(prompt, max_new_tokens=max_new)
        eng.wait(req)
        eng.queue_depth()

    clients = [threading.Thread(target=client, args=(i,))
               for i in range(n_requests)]
    for c in clients:
        c.start()
    deadline = time.monotonic() + 30              # all submitted before run()
    while (eng.gate.tickets.load() < n_requests
           and time.monotonic() < deadline):
        time.sleep(0.005)
    eng.run()
    for c in clients:
        c.join()
    return eng.finish_trace()


def _window_reader_fractions(trace, n_windows: int = 3) -> list[int]:
    """Per-time-window reader fractions — the trace-drawn x-axis."""
    if len(trace.read_s) == 0 or len(trace) == 0:
        return [int(trace.reader_fraction)]
    t_end = max(float(trace.release_s.max()),
                float(trace.read_s.max()) if len(trace.read_s) else 0.0)
    edges = np.linspace(0.0, t_end + 1e-9, n_windows + 1)
    rfs = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        reads = int(np.sum((trace.read_s >= lo) & (trace.read_s < hi)))
        writes = int(np.sum((trace.arrival_s >= lo) & (trace.arrival_s < hi)))
        if reads + writes:
            rfs.append(int(round(100.0 * reads / (reads + writes))))
    return sorted(set(rfs)) or [int(trace.reader_fraction)]


def _e2e_throughput(cfg, params, gate: str, rf: int, *,
                    n_requests: int, max_new: int, device) -> float:
    """Generated tokens/s of a serve run under ``gate`` with ``rf``% of the
    lock operations being metadata reads."""
    eng = ServeEngine(cfg, params, lanes=3, max_ctx=96, temperature=0.7,
                      seed=0, lock=gate, device=device)
    reads_per_req = min(20, int(round(rf / max(1, 100 - rf))))
    tokens = []

    def client(i):
        rng = np.random.default_rng(2000 + i)   # per-thread Generator
        prompt = rng.integers(1, cfg.vocab,
                              size=int(rng.integers(4, 16))).tolist()
        req = eng.submit(prompt, max_new_tokens=max_new)
        eng.wait(req)
        for _ in range(reads_per_req):
            eng.queue_depth()
        tokens.append(len(req.tokens_out))

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(i,))
               for i in range(n_requests)]
    for c in clients:
        c.start()
    deadline = time.monotonic() + 30              # all submitted before run()
    while (eng.gate.tickets.load() < n_requests
           and time.monotonic() < deadline):
        time.sleep(0.005)
    eng.run()
    for c in clients:
        c.join()
    wall = time.perf_counter() - t0
    return sum(tokens) / wall


def run(smoke: bool = False, *, device=None) -> dict:
    dev = resolve_device(device)
    n_requests = 6 if smoke else 10
    max_new = 4 if smoke else 6
    cfg = get_config("gemma3-1b").reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)

    trace_path = os.environ.get(TRACE_ENV, "")
    if trace_path:
        trace = load_trace(trace_path)
    else:
        trace = _record_trace(cfg, params, n_requests=n_requests,
                              max_new=max_new, device=dev)
    tw = quantize_trace(trace, name="serve-e2e")
    coords = trace_workload_coords(tw)
    emit("fig13/trace/requests", str(len(trace)), "recorded")
    emit("fig13/trace/reader_fraction", str(tw.reader_fraction), "percent")
    emit("fig13/trace/n_threads", str(tw.n_threads), "peak_concurrency")

    # lockVM replay over the trace: cells persist to the results store (a
    # throwaway local store when the env hook is unset, so the advisor leg
    # below always has measurements to read).
    own_store = None
    if not os.environ.get(RESULTS_STORE_ENV):
        own_store = tempfile.NamedTemporaryFile(
            suffix=".jsonl", delete=False).name
        os.environ[RESULTS_STORE_ENV] = own_store
    store_path = os.environ[RESULTS_STORE_ENV]
    try:
        spec = trace_sweep_spec(
            tw, locks=SIM_SWEEP_LOCKS,
            seeds=(1,) if smoke else (1, 2, 3),
            horizon=150_000 if smoke else 600_000,
            max_events=300_000 if smoke else 1_200_000)
        sim_rows = run_sweep(spec, device=dev)
        by_lock = {}
        for r in sim_rows:
            by_lock.setdefault(r["lock"], []).append(r["throughput"])
        for lock in SIM_SWEEP_LOCKS:
            emit(f"fig13/sim/{lock}",
                 f"{float(np.median(by_lock[lock])):.6f}", "acq_per_cycle")

        # end-to-end serve throughput per gate x trace-drawn reader_fraction
        rfs = ([int(tw.reader_fraction)] if smoke
               else _window_reader_fractions(trace))
        e2e = {}
        for gate in GATES:
            for rf in rfs:
                tput = _e2e_throughput(cfg, params, gate, rf,
                                       n_requests=n_requests,
                                       max_new=max_new, device=dev)
                e2e[(gate, rf)] = tput
                emit(f"fig13/e2e/{gate}/rf={rf}", f"{tput:.2f}",
                     "tokens_per_s")

        # the loop closes: advisor reads the measurements this figure just
        # persisted, and the serve engine instantiates the answer.
        rec = recommend_lock(ResultsStore(store_path), coords)
        emit("fig13/loop/recommend", rec["lock"], rec["confidence"])
        auto = ServeEngine(cfg, params, lanes=3, max_ctx=96, seed=0,
                           lock="auto", workload=coords, device=dev)
        emit("fig13/loop/auto_gate", auto.gate.kind,
             f"from={auto.lock_choice['sim_lock']}")
    finally:
        if own_store is not None:
            del os.environ[RESULTS_STORE_ENV]
            os.unlink(own_store)
    return {"coords": coords, "e2e": e2e, "recommend": rec,
            "trace": trace, "sim_rows": sim_rows,
            "auto_gate": auto.gate.kind}


if __name__ == "__main__":
    main(run, "serve<->lockVM loop, end to end (fig13)")
