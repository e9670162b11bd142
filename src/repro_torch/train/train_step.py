"""Train-step builder: gradient accumulation over microbatches, autograd
through the model's plain path, the AdamW update.

A port of the reference's ``repro/train/train_step.py``.  The reference
scans the microbatches under ``jax.value_and_grad``; here each microbatch's
loss goes through ``torch.autograd.grad`` in a Python loop, the gradients
summed in ``accum_dtype``.  Parameters stay plain tensors: each step takes
grad-requiring views of them (no copy) for its backward passes.  The
reference's sharding constraints have no counterpart on one card:
``constrain_grads`` is a no-op without a mesh there and here (ROADMAP, the
launch item's ``train/sharding.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..configs.base import ArchConfig
from ..models.model import loss_fn, torch_dtype
from ..optim import AdamW, AdamWState
from ..tree import tree_leaves, tree_map

Pytree = Any

_ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TrainState(NamedTuple):
    params: Pytree
    opt: AdamWState


@dataclass(frozen=True)
class TrainOptions:
    accum_steps: int = 1          # microbatch accumulation
    accum_dtype: str = "float32"  # bf16 accumulator for memory-bound giants
    use_pallas: bool = False      # the ticket-dispatch kernel in every MoE
    # layer (models.model.train_modes)
    constrain_grads: bool = False  # pin grads to the param sharding: a
    # no-op without a mesh, as in the reference (no mesh here yet)


def make_state(cfg: ArchConfig, optimizer: AdamW, seed: int = 0, *,
               device=None) -> TrainState:
    """Fresh parameters from a generator seeded with ``seed`` on ``device``
    (``cuda`` unless named), and the optimizer's zero moments."""
    from ..device import resolve_device
    from ..models.model import init_params
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device=device)
    return TrainState(params=params, opt=optimizer.init(params))


def build_train_step(cfg: ArchConfig, optimizer: AdamW,
                     options: TrainOptions = TrainOptions()):
    """Returns train_step(state, batch) -> (state, metrics).

    batch leaves have leading dim = global_batch; with accumulation the
    batch is split into `accum_steps` microbatches run one after another
    (grads summed in ``accum_dtype``), bounding activation memory by the
    microbatch.
    """
    A = options.accum_steps

    def grads_of(params, mb):
        leaves = tree_leaves(params)
        grad_views = {id(p): p.detach().requires_grad_(True) for p in leaves}
        tracked = tree_map(lambda p: grad_views[id(p)], params)
        with torch.enable_grad():
            loss, metrics = loss_fn(tracked, mb, cfg,
                                    use_pallas=options.use_pallas)
            wrt = [grad_views[id(p)] for p in leaves]
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        by_id = {id(p): torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return tree_map(lambda p: by_id[id(p)], params), metrics

    def _split_mb(x, B):
        """Split the batch axis into (A, B//A); the batch axis is dim 0
        except for M-RoPE 'positions' (3, B, S) where it is dim 1."""
        ax = 0 if x.shape[0] == B else 1
        shape = x.shape[:ax] + (A, x.shape[ax] // A) + x.shape[ax + 1:]
        x = x.reshape(shape)
        return torch.movedim(x, ax, 0) if ax else x

    def train_step(state: TrainState, batch: dict):
        params = state.params
        if A == 1:
            grads, metrics = grads_of(params, batch)
        else:
            B = batch["tokens"].shape[0]
            split = {k: _split_mb(v, B) for k, v in batch.items()}
            adt = _ACCUM_DTYPES[options.accum_dtype]
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                   device=p.device), params)
            ms = []
            for a in range(A):
                g, m = grads_of(params, {k: v[a] for k, v in split.items()})
                grads = tree_map(lambda acc, b: acc + b.to(adt), grads, g)
                ms.append(m)
                del g
            dt = torch_dtype(cfg)
            grads = tree_map(lambda g: (g / A).to(dt), grads)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}

        new_params, new_opt, opt_metrics = optimizer.update(
            grads, state.opt, params)
        metrics = dict(metrics, **opt_metrics)
        return TrainState(new_params, new_opt), metrics

    return train_step
