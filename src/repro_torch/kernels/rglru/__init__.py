"""RG-LRU diagonal gated linear recurrence: plain versions (``ref``), CUDA
kernel wrapper (``kernel``) and the public op (``ops``)."""

from .ops import MODES, rglru_scan
from .ref import rglru_gates_ref, rglru_scan_chunked, rglru_scan_ref

__all__ = ["MODES", "rglru_gates_ref", "rglru_scan", "rglru_scan_chunked",
           "rglru_scan_ref"]
