"""The plain PyTorch version of the Mamba-1 mixer's causal depthwise conv,
its bias and its SiLU: kw shifted views of the padded input stacked, an
einsum over the width, the bias added, then the SiLU; the tail (the decode
state) is the padded input's last kw-1 rows, copied out.  Every step
rounds to x's dtype, as PyTorch computes each.  Under a mesh the pad runs
on each device's part (:func:`repro_torch.models.shard_utils.pad`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...models.shard_utils import pad


def causal_conv_ref(x, w, b) -> tuple[torch.Tensor, torch.Tensor]:
    """(silu(conv(x) + b), tail) for x (B, S, d), w (d, kw), b (d,): the
    conv pads kw-1 zeros in front, so a prompt shorter than kw-1 leaves
    zeros in the tail (B, kw-1, d)."""
    S, kw = x.shape[1], w.shape[-1]
    xpad = pad(x, (0, 0, kw - 1, 0))
    shifted = torch.stack([xpad[:, i:i + S] for i in range(kw)], dim=3)
    conv = torch.einsum("bsdk,dk->bsd", shifted, w) + b
    # the tail copied out: a view would keep the whole padded input alive
    tail = (xpad[:, S:] if kw == 1 else xpad[:, -(kw - 1):]).clone()
    return F.silu(conv), tail
