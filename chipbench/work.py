"""The yardstick's arithmetic: the card's published peaks, a Mamba-1
stack's model FLOPs a token, and the selective scan's least time.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense
rates: 989e12 FLOP/s in bf16 on the tensor cores, 67e12 in float32 outside
them, 3.35e12 bytes/s of HBM.
"""

from __future__ import annotations

import math

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def mamba_sizes(arch: dict) -> dict:
    d = arch["d_model"]
    return {"d": d, "di": arch["ssm_expand"] * d, "N": arch["ssm_state"],
            "kw": arch["ssm_conv"],
            "dtr": arch.get("dt_rank") or math.ceil(d / 16),
            "layers": arch["n_layers"], "V": arch["vocab"]}


def mamba_token_flops(arch: dict) -> float:
    """Model FLOPs of one token through the stack, without the head: two a
    weight of each product (in, x, dt and out projections), the depthwise
    conv's two a tap, and the scan's seven a state (``exp(dt·A)``,
    ``dt·x·B``, the update of h and its product with C) and two a channel
    (the skip)."""
    s = mamba_sizes(arch)
    d, di, N, dtr = s["d"], s["di"], s["N"], s["dtr"]
    weights = d * 2 * di + di * (dtr + 2 * N) + dtr * di + di * d
    per_layer = 2 * weights + 2 * di * s["kw"] + 7 * di * N + 2 * di
    return float(s["layers"] * per_layer)


def mamba_head_flops(arch: dict) -> float:
    """The output head's FLOPs at one position."""
    return float(2 * arch["d_model"] * arch["vocab"])


def prefill_flops(arch: dict, prompt_tokens: int) -> float:
    """A prefill: every prompt token through the stack, and the head at the
    position whose logits are sampled."""
    return prompt_tokens * mamba_token_flops(arch) + mamba_head_flops(arch)


def decode_flops(arch: dict, tokens: int) -> float:
    """Decode: each generated token through the stack and the head."""
    return tokens * (mamba_token_flops(arch) + mamba_head_flops(arch))


def scan_bound_s(L: int, D: int, N: int, elem: int = 2) -> float:
    """Least time of one selective scan over L steps of D channels with N
    states (a prefill starts from zero, so no h0 is read): the larger of
    its bytes (x, dt, y (L, D); A, h (D, N); B, C (L, N); D_skip, each
    once) over the HBM rate and its operations (seven a state and step,
    two a channel and step) over the float32 rate.  Copied from the
    program's ``bench/kernel_bounds.py``."""
    nbytes = elem * (3 * L * D + 2 * D * N + 2 * L * N + D)
    ops = 7 * L * D * N + 2 * L * D
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)


def mfu_pct(facts: dict) -> float | None:
    """A driver's ``model_flops`` over its window times the bf16 peak, in
    percent."""
    if not facts.get("model_flops"):
        return None
    return facts["model_flops"] / (facts["window_s"] * BF16_FLOPS) * 100.0
