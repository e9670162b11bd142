"""Public op for the causal conv: the CUDA kernel or the plain version.

``mode`` is the mixer's scan mode (:data:`repro_torch.kernels.mamba_scan
.ops.MODES`), which picks both of its kernels: ``"auto"`` launches the
kernel (:func:`kernel.causal_conv`) for CUDA tensors and runs the plain
version for CPU tensors; ``"torch"`` runs the plain version on any device
(the yardstick the smoke run holds the kernel against).
"""

from __future__ import annotations

from ..mamba_scan.ops import MODES
from . import kernel
from .ref import causal_conv_ref


def causal_conv(x, w, b, mode: str = "auto"):
    """(silu(conv(x) + b), tail) — the causal depthwise conv of x (B, S,
    d) with w (d, kw) and its bias b (d,); shapes as
    :func:`ref.causal_conv_ref`."""
    if mode not in MODES:
        raise ValueError(f"unknown scan mode {mode!r}; options: {MODES}")
    if mode == "auto" and x.device.type != "cpu":
        return kernel.causal_conv(x, w, b)
    return causal_conv_ref(x, w, b)
