"""Fault tolerance end-to-end: train, 'lose' hosts, re-mesh, resume.

Phase 1 trains with world=4 data shards and checkpoints.  Phase 2 pretends
one host died (world 4 -> 3 hosts -> remesh to 2 shards), restores the
checkpoint onto the new layout, and continues — losses line up with an
uninterrupted run because the synthetic data pipeline addresses batches by
global step, not iterator state.

The reference's ``examples/elastic_restart.py``, with ``--device`` and
``--ckpt-dir`` (a temporary directory, removed at the end, unless named).
No mesh is built: each phase assembles the global batch from the
per-host shards (bitwise identical for any world size) and prints
``remesh_plan``'s plan::

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from ..ckpt import AsyncCheckpointer, latest_step, restore
from ..configs import get_config
from ..core import InMemoryKVStore
from ..data import SyntheticLM
from ..device import resolve_device
from ..optim import AdamW
from ..runtime import HeartbeatMonitor, remesh_plan
from ..train.train_step import TrainOptions, build_train_step, make_state

ARCH = "deepseek-7b"
GLOBAL_BATCH, SEQ = 8, 32
DRIFT_LIMIT = 5e-3


def run_phase(step_fn, cfg, state, start, stop, world, device, ck=None):
    """Simulate ``world`` data-parallel hosts: each host's shard of the
    global batch, assembled into the global batch (bitwise identical to
    any world size)."""
    losses = []
    for step in range(start, stop):
        shards = [SyntheticLM(cfg, batch=GLOBAL_BATCH, seq=SEQ, shard=h,
                              num_shards=world).batch_at(step)
                  for h in range(world)]
        batch = {k: torch.from_numpy(np.concatenate([s[k] for s in shards]))
                 .to(device) for k in shards[0]}
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        if ck:
            ck.save(state, step + 1)
    return state, losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a temporary one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="repro_elastic_") as tmp:
        return _run(device, args.ckpt_dir or tmp)


def _run(device, ckpt_dir: str) -> dict:
    cfg = get_config(ARCH).reduced()
    optimizer = AdamW(lr=1e-3)
    step_fn = build_train_step(cfg, optimizer, TrainOptions())

    store = InMemoryKVStore()
    hb = HeartbeatMonitor(store, ttl_s=0.2)
    ck = AsyncCheckpointer(ckpt_dir)

    # phase 1: 4 hosts
    state = make_state(cfg, optimizer, 0, device=device)
    state, l1 = run_phase(step_fn, cfg, state, 0, 6, 4, device, ck=ck)
    ck.wait()
    for h in range(4):
        hb.beat(h)
    print(f"phase 1 (world=4): steps 0-5, loss {l1[0]:.4f} -> {l1[-1]:.4f}, "
          f"checkpoint @ step {latest_step(ckpt_dir)}")

    # host 3 dies
    time.sleep(0.3)
    for h in range(3):
        hb.beat(h)
    dead = hb.dead(range(4))
    print(f"heartbeat monitor: dead hosts = {dead}")

    # re-mesh: 3 surviving hosts, 16 chips each = 48 chips, TP=16
    plan = remesh_plan(48, model=16, old_data=3, global_batch=GLOBAL_BATCH)
    print(f"remesh plan: mesh {plan.mesh_shape} ({plan.chips_used} chips, "
          f"{plan.chips_idle} idle), reshard={plan.reshard}")

    # phase 2: restore onto the new world and continue
    restored, at = restore(ckpt_dir, like=state)
    world2 = plan.data * plan.pods
    state2, l2 = run_phase(step_fn, cfg, restored, at, at + 4, world2, device)

    # reference: uninterrupted single-world run
    ref_state = make_state(cfg, optimizer, 0, device=device)
    ref_state, ref_losses = run_phase(step_fn, cfg, ref_state, 0, 10, 1,
                                      device)

    drift = max(abs(a - b) for a, b in zip(l1 + l2, ref_losses))
    print(f"phase 2 (world={world2}): steps {at}-{at + 3}, "
          f"loss {l2[0]:.4f} -> {l2[-1]:.4f}")
    verdict = "OK" if drift < DRIFT_LIMIT else "MISMATCH"
    print(f"max |loss drift| vs uninterrupted run: {drift:.2e} ({verdict})")
    return {"phase1_losses": l1, "dead": dead, "plan": plan,
            "resumed_at": at, "phase2_losses": l2,
            "uninterrupted_losses": ref_losses, "drift": drift,
            "verdict": verdict}


if __name__ == "__main__":
    main()
