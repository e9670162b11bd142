"""End-to-end serving: continuous batching with ticket-FIFO admission.

Client threads submit prompts and block in TWA two-tier waiting; the engine
prefills into free lanes, decodes all lanes in one batched step, and
advances the grant counter as lanes finish.  Prints per-request latency and
the admission telemetry that shows bounded hot-counter polling.

The reference's ``examples/serve_continuous_batching.py``, with
``--device`` (weights random from a generator seeded 0)::

    PYTHONPATH=src python -m repro_torch.examples.serve_continuous_batching
    PYTHONPATH=src python -m repro_torch.examples.serve_continuous_batching \\
        --lock fissile-twa --record trace.npz

``--record PATH`` captures a LockTrace (.npz) of the run — per-request
arrival/grant/release timestamps plus metadata reads — which
``repro_torch.sim.traces`` compiles into a sweepable lockVM workload.
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.model import init_params
from ..serve import ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--lanes", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=10,
                    help="upper bound on sampled max_new_tokens per request")
    ap.add_argument("--lock", default=None,
                    help="admission gate: ticket | twa | fissile-twa | "
                         "twa-rw | auto | any SIM_LOCKS name "
                         "(default: historical twa two-tier)")
    ap.add_argument("--record", default="",
                    help="save the run's LockTrace to this .npz")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    eng = ServeEngine(cfg, params, lanes=args.lanes, max_ctx=96,
                      temperature=0.7, seed=0, lock=args.lock,
                      record_trace=bool(args.record), device=device)

    results = {}

    def client(i):
        rng = np.random.default_rng(1000 + i)   # per-thread: Generator is
        prompt = rng.integers(1, cfg.vocab,     # not thread-safe
                              size=int(rng.integers(4, 20))).tolist()
        t0 = time.time()
        lo = min(4, args.max_new)               # --max-new is inclusive
        req = eng.submit(prompt,
                         max_new_tokens=int(rng.integers(lo,
                                                         args.max_new + 1)))
        eng.wait(req)                  # two-tier TWA waiting for admission
        eng.queue_depth()              # metadata read (twa-rw's fast path)
        results[req.ticket] = {
            "latency_s": time.time() - t0,
            "prompt_len": len(prompt),
            "max_new": req.max_new_tokens,
            "generated": req.tokens_out,
            "admit_step": req.admitted_at_step,
        }

    clients = [threading.Thread(target=client, args=(i,))
               for i in range(args.requests)]
    for c in clients:
        c.start()
    # run() returns once nothing is pending, so wait until every client has
    # actually drawn its ticket (a fixed sleep races on a loaded machine)
    deadline = time.time() + 30
    while eng.gate.tickets.load() < args.requests and time.time() < deadline:
        time.sleep(0.005)
    engine = threading.Thread(target=eng.run)
    engine.start()
    engine.join()
    for c in clients:
        c.join()

    print(f"{'ticket':>7} {'prompt':>7} {'#gen':>5} {'admit@':>7} "
          f"{'latency':>9}")
    for tx in sorted(results):
        r = results[tx]
        print(f"{tx:>7} {r['prompt_len']:>7} {len(r['generated']):>5} "
              f"{r['admit_step']:>7} {r['latency_s']:>8.2f}s")
    admits = [results[tx]["admit_step"] for tx in sorted(results)]
    if not all(a <= b for a, b in zip(admits, admits[1:])):
        raise AssertionError("FIFO violated!")
    print(f"\nFIFO admission order: OK ({args.requests} requests, "
          f"{args.lanes} lanes, gate={eng.gate.kind})")
    stats = eng.stats()
    print("admission telemetry:", stats)

    trace = None
    if args.record:
        trace = eng.finish_trace()
        trace.save(args.record)
        print(f"recorded LockTrace: {len(trace)} requests, "
              f"reader_fraction={trace.reader_fraction}% -> {args.record}")
    return {"results": results, "gate": eng.gate.kind, "stats": stats,
            "trace": trace}


if __name__ == "__main__":
    main()
