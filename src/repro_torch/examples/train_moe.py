"""End-to-end driver: train a ~100M-param MoE LM for a few hundred steps.

The model is a scaled granite-style MoE (8 experts, top-2) whose expert
dispatch runs through the ticket-dispatch doorway (the paper's
fetch-and-add as a per-expert prefix count).  Training uses the full
substrate: TWA-guarded prefetch, AdamW, grad accumulation, async
checkpoints, heartbeat + straggler tickets.

The reference's ``examples/train_moe.py``, with ``--device``; the
checkpoints go to ``--ckpt-dir`` (default ``repro_torch_train_moe`` in
the temporary directory)::

    PYTHONPATH=src python -m repro_torch.examples.train_moe [--steps 300]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from ..ckpt import AsyncCheckpointer
from ..configs import get_config
from ..configs.base import ArchConfig
from ..core import InMemoryKVStore
from ..data import Prefetcher, SyntheticLM
from ..device import resolve_device
from ..optim import AdamW
from ..optim.schedules import warmup_cosine
from ..runtime import HeartbeatMonitor, StepTickets
from ..train.train_step import TrainOptions, build_train_step, make_state

WARMUP_STEPS, CKPT_EVERY, LOG_EVERY = 20, 100, 10


def model_config() -> ArchConfig:
    """~100M params: the granite-moe family, scaled down (float32)."""
    return dataclasses.replace(
        get_config("granite-moe-1b-a400m"),
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=768, n_experts=8, top_k=2, vocab=32768, tie_embeddings=False,
        dtype="float32", remat="none", scan_layers=True,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_moe"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = model_config()
    print(f"model: {cfg.param_count() / 1e6:.1f}M params "
          f"({cfg.active_param_count() / 1e6:.1f}M active), "
          f"{cfg.n_layers}L x {cfg.d_model}d, {cfg.n_experts}e "
          f"top-{cfg.top_k}")

    optimizer = AdamW(lr=args.lr,
                      schedule=warmup_cosine(WARMUP_STEPS, args.steps))
    step_fn = build_train_step(cfg, optimizer, TrainOptions())
    state = make_state(cfg, optimizer, 0, device=device)

    src = SyntheticLM(cfg, batch=args.batch, seq=args.seq)
    ck = AsyncCheckpointer(args.ckpt_dir)
    store = InMemoryKVStore()
    hb, tickets = HeartbeatMonitor(store), StepTickets(store)

    losses, auxes = [], []
    t0 = time.time()
    with Prefetcher(src, depth=2) as pf:
        for _ in range(args.steps):
            step, batch = pf.get()
            hb.beat(0)
            tickets.arrive(0, step)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux"]))
            if step % LOG_EVERY == 0:
                rate = (step + 1) * args.batch * args.seq / (time.time() - t0)
                print(f"step {step:4d}  loss {losses[-1]:.4f}  aux "
                      f"{auxes[-1]:.4f}  {rate:,.0f} tok/s", flush=True)
            if (step + 1) % CKPT_EVERY == 0:
                ck.save(state, step + 1)
    ck.wait()
    seconds = time.time() - t0

    first10 = sum(losses[:10]) / 10
    last10 = sum(losses[-10:]) / 10
    print(f"\nloss: first-10 avg {first10:.4f} -> last-10 avg {last10:.4f}")
    if not last10 < first10:
        raise AssertionError("model did not learn")
    print(f"done: {args.steps} steps in {seconds:.0f}s; "
          f"checkpoints in {args.ckpt_dir}")
    return {"losses": losses, "aux": auxes, "first10": first10,
            "last10": last10, "seconds": seconds,
            "checkpoints": ck.history, "params": cfg.param_count()}


if __name__ == "__main__":
    main()
