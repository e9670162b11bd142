"""Public op for the selective scan: the CUDA kernel or the plain version.

``mode="auto"`` launches the kernel (:func:`kernel.selective_scan`) for CUDA
tensors and runs the plain version for CPU tensors; ``mode="torch"`` runs
the plain version on any device (the yardstick the smoke run holds the
kernel against).  The plain path keeps the reference's rule
(``repro/kernels/mamba_scan/ops.py``): ``$REPRO_SCAN_CHUNK=<Lc>``, read at
each call, selects the chunked formulation when Lc divides L; unset or 0
keeps the sequential loop.
"""

from __future__ import annotations

import os

from . import kernel
from .ref import selective_scan_chunked, selective_scan_ref

MODES = ("auto", "torch")


def selective_scan(x, dt, A, B, C, D_skip, h0=None, mode: str = "auto"):
    """(y, h_final) — the Mamba-1 selective scan over (L, D) or (Bt, L, D)
    inputs (shapes as :func:`ref.selective_scan_ref`)."""
    if mode not in MODES:
        raise ValueError(f"unknown scan mode {mode!r}; options: {MODES}")
    if mode == "auto" and x.device.type != "cpu":
        return kernel.selective_scan(
            *(t.contiguous() for t in (x, dt, A, B, C, D_skip)),
            None if h0 is None else h0.contiguous())
    chunk = int(os.environ.get("REPRO_SCAN_CHUNK", "0"))
    if chunk > 0 and x.shape[-2] % chunk == 0:
        return selective_scan_chunked(x, dt, A, B, C, D_skip, h0,
                                      chunk=chunk)
    return selective_scan_ref(x, dt, A, B, C, D_skip, h0)
