"""Public op for the RG-LRU scan: the CUDA kernel or the plain version.

``mode="auto"`` launches the kernel (:func:`kernel.rglru_scan`) for CUDA
tensors and runs the plain version for CPU tensors; ``mode="torch"`` runs
the plain version on any device (the yardstick the smoke run holds the
kernel against).  The plain path keeps the reference's rule
(``repro/kernels/rglru/ops.py``): ``$REPRO_SCAN_CHUNK=<Lc>``, read at each
call, selects the chunked formulation when Lc divides L; unset or 0 keeps
the sequential loop.
"""

from __future__ import annotations

import os

from . import kernel
from .ref import rglru_scan_chunked, rglru_scan_ref

MODES = ("auto", "torch")


def rglru_scan(a, b, h0=None, mode: str = "auto"):
    """(y, h_final) — h_t = a_t ⊙ h_{t-1} + b_t over (L, D) or (Bt, L, D)
    inputs (shapes as :func:`ref.rglru_scan_ref`)."""
    if mode not in MODES:
        raise ValueError(f"unknown scan mode {mode!r}; options: {MODES}")
    if mode == "auto" and a.device.type != "cpu":
        return kernel.rglru_scan(a.contiguous(), b.contiguous(),
                                 None if h0 is None else h0.contiguous())
    chunk = int(os.environ.get("REPRO_SCAN_CHUNK", "0"))
    if chunk > 0 and a.shape[-2] % chunk == 0:
        return rglru_scan_chunked(a, b, h0, chunk=chunk)
    return rglru_scan_ref(a, b, h0)
