"""int8 gradient compression with error feedback — for the slow inter-pod
axis.  all_reduce(int8(g)) + residual carry; standard large-scale trick
(1-bit Adam / PowerSGD family, simplest member).  A port of the
reference's ``repro/optim/compress.py`` over the port's trees."""

from __future__ import annotations

from typing import Any

import torch

from ..tree import tree_map

Pytree = Any


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization; returns (q, scale)."""
    amax = torch.max(torch.abs(x)).to(torch.float32)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads: Pytree, residual: Pytree) -> tuple[Pytree, Pytree, Pytree]:
    """Quantize (grads + residual); returns (q_tree, scales, new_residual)."""
    def one(g, r):
        x = g.to(torch.float32) + r
        q, s = quantize_int8(x)
        back = dequantize_int8(q, s)
        return q, s, x - back  # residual carries quantization error

    out = tree_map(one, grads, residual)
    # out's leaves are one's tuples; the walk follows grads' structure
    pick = lambda i: tree_map(lambda _, o: o[i], grads, out)
    return pick(0), pick(1), pick(2)


def init_residual(params: Pytree) -> Pytree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
