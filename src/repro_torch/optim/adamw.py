"""AdamW, built from scratch: fp32 moments over bf16 params, decoupled
weight decay, global-norm clipping.

A port of the reference's ``repro/optim/adamw.py`` over the port's trees
(dicts, lists and NamedTuples of tensors, :mod:`repro_torch.tree`).  The
update is functional, as the reference's: it returns new parameter and
moment trees and leaves its inputs untouched.  Every element follows the
reference's arithmetic order (clip scale, moments, bias corrections,
decoupled decay, the step rounded to the parameter's dtype).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..tree import tree_leaves, tree_map

Pytree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Pytree               # fp32, like params
    v: Pytree               # fp32, like params


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Any = None    # optional callable step -> lr multiplier
    moment_dtype: str = "float32"  # "bfloat16" halves optimizer memory

    def init(self, params: Pytree) -> AdamWState:
        mdt = _DTYPES[self.moment_dtype]
        device = tree_leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads: Pytree, state: AdamWState,
               params: Pytree) -> tuple[Pytree, AdamWState, dict]:
        step = state.step + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0) \
            if self.clip_norm else 1.0
        lr = self.lr * (self.schedule(step) if self.schedule else 1.0)

        stepf = step.to(torch.float32)
        b1c = 1.0 - torch.pow(self.b1, stepf)
        b2c = 1.0 - torch.pow(self.b2, stepf)

        mdt = _DTYPES[self.moment_dtype]

        def upd(g, m, v, p):
            g32 = g.to(torch.float32) * scale
            m2 = self.b1 * m.to(torch.float32) + (1 - self.b1) * g32
            v2 = self.b2 * v.to(torch.float32) + (1 - self.b2) * \
                torch.square(g32)
            del g32
            mh = m2 / b1c
            vh = v2 / b2c
            delta = mh / (torch.sqrt(vh) + self.eps)
            del mh, vh
            if self.weight_decay:
                delta = delta + self.weight_decay * p.to(torch.float32)
            return ((p.to(torch.float32) - lr * delta).to(p.dtype),
                    m2.to(mdt), v2.to(mdt))

        out = tree_map(upd, grads, state.m, state.v, params)
        # out's leaves are upd's tuples; the walk follows grads' structure
        pick = lambda i: tree_map(lambda _, o: o[i], grads, out)
        return pick(0), AdamWState(step, pick(1), pick(2)), {
            "grad_norm": gnorm, "lr": lr}


def global_norm(tree: Pytree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))
