"""Training launcher: data pipeline -> train_step -> checkpoints, with
heartbeats, straggler tickets and restart-from-checkpoint.

A port of the reference's ``repro/launch/train.py``, with its command line
and its ``[train]`` lines, plus ``--device`` (``cuda`` unless named; with
no GPU and no device named it raises) and ``--use-pallas`` (the reference's
``TrainOptions.use_pallas``: every MoE layer's slots from the ticket-dispatch
kernel).  CPU-runnable with reduced configs::

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
        --reduced --device cpu --steps 4

The batches come from the Prefetcher, whose ring buffer is guarded by the
paper's lock (``core.make_lock``: TWA unless ``$REPRO_LOCK`` names another);
checkpoints are written by the AsyncCheckpointer in the reference's layout.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..ckpt import AsyncCheckpointer, latest_step, restore
from ..configs import get_config
from ..core import InMemoryKVStore
from ..data import Prefetcher, SyntheticLM
from ..device import resolve_device
from ..optim import AdamW
from ..runtime import HeartbeatMonitor, StepTickets
from ..train.train_step import TrainOptions, build_train_step, make_state


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--use-pallas", action="store_true",
                    help="MoE slots from the ticket-dispatch kernel")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    optimizer = AdamW(lr=args.lr)
    step_fn = build_train_step(
        cfg, optimizer, TrainOptions(accum_steps=args.accum,
                                     use_pallas=args.use_pallas))

    state = make_state(cfg, optimizer, args.seed, device=device)
    start_step = 0
    ck = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and args.resume and latest_step(args.ckpt_dir) is not None:
        state, start_step = restore(args.ckpt_dir, like=state)
        print(f"[train] resumed from step {start_step}", flush=True)

    store = InMemoryKVStore()
    hb = HeartbeatMonitor(store)
    tickets = StepTickets(store)

    src = SyntheticLM(cfg, batch=args.batch, seq=args.seq, seed=args.seed)
    losses, step_seconds = [], []
    t0 = time.time()
    with Prefetcher(src, start_step=start_step) as pf:
        for _ in range(start_step, args.steps):
            t_step = time.perf_counter()
            step, batch = pf.get()
            hb.beat(0)
            tickets.arrive(0, step)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            step_seconds.append(time.perf_counter() - t_step)
            if step % args.log_every == 0:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"({(time.time() - t0):.1f}s)", flush=True)
            if ck and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                ck.save(state, step + 1)
    if ck:
        ck.wait()
    if len(losses) >= 2:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'improved' if losses[-1] < losses[0] else 'NOT improved'})",
              flush=True)
    return {"losses": losses, "final_state": state,
            "start_step": start_step, "step_seconds": step_seconds,
            "checkpoints": ck.history if ck else []}


if __name__ == "__main__":
    main()
