"""Mamba-1 selective scan: plain versions (``ref``), CUDA kernel wrapper
(``kernel``) and the public op (``ops``)."""

from .ops import MODES, selective_scan
from .ref import selective_scan_chunked, selective_scan_ref

__all__ = ["MODES", "selective_scan", "selective_scan_chunked",
           "selective_scan_ref"]
