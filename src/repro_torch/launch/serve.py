"""Serving driver: continuous batching with ticket-FIFO admission.

On the GPU (the default device)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m

On the CPU with a reduced config::

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-1b-a400m --reduced --device cpu

Every decoder of ``repro_torch.configs`` serves the same way, with its
weights in bf16 on one 80 GB card:

- ``granite-moe-1b-a400m`` (2.7 GB) and ``grok-1-314b`` (MoE: every MoE
  layer's routing plan is one launch of the routing-plan kernel on the
  GPU; grok's 64 layers take 633 GB, so on one card only a cut depth
  serves, 4 layers in 42.6 GB);
- ``deepseek-7b`` (13.8 GB) and ``mistral-large-123b`` (245 GB: on one
  card 8 of its 88 layers, 23.8 GB);
- ``gemma3-1b`` (2.0 GB) and ``gemma2-27b`` (54.5 GB): local and global
  attention, the local layers' caches rings of the window;
- ``falcon-mamba-7b`` (14.5 GB), the Mamba-1 stack, whose prefills run the
  selective-scan kernel on the GPU;
- ``recurrentgemma-9b`` (18.8 GB), the Griffin hybrid (RG-LRU and
  sliding-window attention), whose prefills run the RG-LRU scan kernel on
  the GPU.

Each runs here with ``--arch <name> --reduced --device cpu``.
``qwen2-vl-72b`` is served by neither package: its prefill reads a
``vision_mask`` that a prompt of tokens does not carry (``KeyError``), as
in the reference; ``hubert-xlarge`` is encoder-only.

The flags and the printout are the reference's (``repro.launch.serve``),
plus ``--device``; weights are random, drawn from ``--seed``.  The
launcher gives the CUDA caching allocator expandable segments unless the
caller set ``$PYTORCH_CUDA_ALLOC_CONF``
(``repro_torch.device.default_allocator``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import default_allocator, resolve_device
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
    default_allocator(device)
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
