"""FIFO ticket dispatch as one CUDA kernel launch
(``csrc/ticket_dispatch.cu``).

Counterpart of the reference's Pallas kernel ``_ticket_kernel``
(``repro/kernels/ticket_dispatch/kernel.py``, wrapper
``ticket_dispatch_pallas``).  :func:`ticket_dispatch` launches one thread
block of :data:`THREADS` threads per group; each block walks its group's
arrivals in order, a chunk of :data:`THREADS` at a time, with the
per-expert counters carried in shared memory.  The kernel is built with
``nvcc`` at first use (:mod:`repro_torch._build`).

Ids outside [0, E) follow the reference's rule (see
:mod:`repro_torch.kernels.ticket_dispatch.ref`): an id in [-E, 0) wraps
once to expert ``id + E`` and takes its count of earlier arrivals, any
other takes ticket and slot INT32_MIN, and neither moves a counter.

For tensors on the CPU the wrapper runs the plain version
(:func:`repro_torch.kernels.ticket_dispatch.ref.dispatch_ref`); for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from . import ref

# Threads of one block: a chunk of arrivals ranked together (16 warps).
THREADS = 512
# Shared memory one block may use on Hopper (sm_90): 227 KB.
SMEM_LIMIT = 232_448
# The block keeps one counter per expert plus one per (warp, expert).
MAX_EXPERTS = SMEM_LIMIT // (4 * (THREADS // 32 + 1))
INT32_MAX = 2**31 - 1

# Kernel launches made by ticket_dispatch (read by chip_smoke.py to show
# that a serve run went through the kernel).
launches = 0


def smem_bytes(n_experts: int) -> int:
    """Dynamic shared memory of one block for ``n_experts`` experts."""
    return 4 * (THREADS // 32 + 1) * n_experts


def _library() -> ctypes.CDLL:
    lib = _build.load_library("ticket_dispatch")
    if not getattr(lib, "_ticket_typed", False):
        lib.ticket_dispatch_run.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.ticket_dispatch_run.restype = ctypes.c_int
        lib.ticket_dispatch_smem_bytes.argtypes = [ctypes.c_int]
        lib.ticket_dispatch_smem_bytes.restype = ctypes.c_int64
        lib._ticket_typed = True
    return lib


def smem_bytes_from_kernel(n_experts: int) -> int:
    """The compiled library's own count (checks :func:`smem_bytes`)."""
    return int(_library().ticket_dispatch_smem_bytes(n_experts))


def ticket_dispatch(expert_ids: torch.Tensor, n_experts: int,
                    capacity: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(tickets, slots) of a (G, n) int32 tensor of expert ids, each row an
    independent group of arrivals in arrival order.

    ``slots`` is the ticket, or -1 where the ticket reaches ``capacity``
    (``None``: no capacity); ids outside [0, E) as in :mod:`ref`.  On a CUDA device this is one kernel launch on
    the current stream; it does not synchronise.
    """
    global launches
    if expert_ids.dim() != 2:
        raise ValueError(f"expert_ids must be (groups, n), got shape "
                         f"{tuple(expert_ids.shape)}")
    if expert_ids.dtype != torch.int32:
        raise TypeError(f"expert_ids must be int32, got {expert_ids.dtype}")
    if not expert_ids.is_contiguous():
        raise ValueError("expert_ids must be contiguous")
    if not 0 < n_experts <= MAX_EXPERTS:
        raise ValueError(f"n_experts must lie in [1, {MAX_EXPERTS}] (the "
                         f"counters live in shared memory), got {n_experts}")
    cap = INT32_MAX if capacity is None else int(capacity)
    if not 0 <= cap <= INT32_MAX:
        raise ValueError(f"capacity must lie in [0, 2**31), got {capacity}")
    dev = expert_ids.device
    if dev.type == "cpu":
        return ref.dispatch_ref(expert_ids, n_experts, cap, grouped=True)
    if dev.type != "cuda":
        raise ValueError(f"the ticket kernel runs on CUDA tensors, got {dev}")
    groups, n = expert_ids.shape
    tickets = torch.empty_like(expert_ids)
    slots = torch.empty_like(expert_ids)
    if groups == 0 or n == 0:
        return tickets, slots
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ticket_dispatch_run(
            expert_ids.data_ptr(), tickets.data_ptr(), slots.data_ptr(),
            n, groups, n_experts, cap, stream)
    if rc != 0:
        raise RuntimeError(f"ticket_dispatch kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return tickets, slots
