"""Serving driver: continuous batching with ticket-FIFO admission.

On the GPU (the default device)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m

On the CPU with a reduced config::

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-1b-a400m --reduced --device cpu

Any ported decoder serves the same way: ``--arch falcon-mamba-7b`` is the
Mamba-1 stack, whose prefills run the selective-scan kernel on the GPU;
``--arch recurrentgemma-9b`` the Griffin hybrid (RG-LRU and sliding-window
attention, 9.4 B parameters, 18.8 GB in bf16), whose prefills run the
RG-LRU scan kernel on the GPU.

The flags and the printout are the reference's (``repro.launch.serve``),
plus ``--device``; weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.model import init_params
from ..serve import ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-ctx", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")

    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)
    eng = ServeEngine(cfg, params, lanes=args.lanes, max_ctx=args.max_ctx,
                      temperature=args.temperature, seed=args.seed,
                      device=device)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    reqs = [eng.submit(rng.integers(1, cfg.vocab,
                                    size=int(rng.integers(4, 17))).tolist(),
                       max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    eng.run()
    dt = time.time() - t0
    tokens = sum(len(r.tokens_out) for r in reqs)
    stats = eng.stats()
    print(f"[serve] {len(reqs)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens / dt:.1f} tok/s), {stats['steps']} engine steps "
          f"on {device}")
    print(f"[serve] admission: grant_polls={stats['grant_polls']} "
          f"slot_polls={stats['slot_polls']} "
          f"long_term_entries={stats['long_term_entries']}")
    for r in reqs[:4]:
        print(f"  req#{r.ticket}: prompt[:4]={r.prompt[:4]} "
              f"-> out={r.tokens_out}")
    return {"requests": reqs, "stats": stats}


if __name__ == "__main__":
    main()
