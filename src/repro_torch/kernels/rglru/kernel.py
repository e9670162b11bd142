"""The RG-LRU scan as one CUDA kernel launch (``csrc/rglru_scan.cu``).

Counterpart of the reference's Pallas kernel ``_rglru_kernel``
(``repro/kernels/rglru/kernel.py``, wrapper ``rglru_scan_pallas``), with
its contract: a, b and h0 are read in their dtypes (float32 or bf16), h
stays in float32, y and h_final come back in a's dtype.
:func:`rglru_scan` launches one block per (sequence, :data:`CHANNELS`
channels): a chain warp, one lane a channel, walks all L steps with its h
in a register, reading a and b from a ring of :data:`STAGES` stages of
:data:`STEPS` steps in shared memory that a copy warp fills ahead of it
(``cp.async``) and a store warp drains of y behind it.  The kernel is built with
``nvcc`` at first use (:mod:`repro_torch._build`).

For tensors on the CPU the wrapper runs the plain version
(:func:`repro_torch.kernels.rglru.ref.rglru_scan_ref`); for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import refuse_autograd
from . import ref

# Channels of one block (the chain warp's lanes), so that one sequence at
# D 4,096 is 128 blocks on the card's 132 SMs.
CHANNELS = 32
# Threads of one block: the chain warp, the copy warp and the store warp.
THREADS = 96
# Steps of a and b a stage of the ring holds (the chain loads a stage into
# registers at once), and the stages of the ring (why these:
# csrc/rglru_scan.cu).
STEPS = 64
STAGES = 6
MAX_BATCH = 65535   # the grid's second dimension

_DTYPES = (torch.float32, torch.bfloat16)
# bit of each input in the kernel's dtype mask (set = bf16)
BF16_BITS = {"a": 1, "b": 2, "h0": 4}

# Kernel launches made by rglru_scan (read by chip_smoke.py to show that a
# serve run went through the kernel).
launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.load_library("rglru_scan")
    if not getattr(lib, "_scan_typed", False):
        lib.rglru_scan_run.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 3 + [ctypes.c_int64, ctypes.c_uint,
                                 ctypes.c_void_p]
        lib.rglru_scan_run.restype = ctypes.c_int
        lib.rglru_scan_smem_bytes.argtypes = [ctypes.c_uint]
        lib.rglru_scan_smem_bytes.restype = ctypes.c_int
        lib._scan_typed = True
    return lib


def smem_bytes(bf16_a: bool, bf16_b: bool) -> int:
    """Dynamic shared memory of one block: three 8-byte barriers a stage
    (padded to 32 bytes) and the ring's rows of a and b."""
    return STAGES * (32 + STEPS * CHANNELS * ((2 if bf16_a else 4)
                                              + (2 if bf16_b else 4)))


def smem_bytes_from_kernel(mask: int) -> int:
    """The compiled library's own count for a dtype mask (checks
    :func:`smem_bytes`)."""
    return int(_library().rglru_scan_smem_bytes(mask))


def _check(name: str, t: torch.Tensor, shapes: tuple, device) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if tuple(t.shape) not in shapes:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected one "
                         f"of {[list(s) for s in shapes]}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, a on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rglru_scan(a, b, h0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, h_final) of h_t = a_t ⊙ h_{t-1} + b_t; the shapes of
    :func:`ref.rglru_scan_ref`: a, b (L, D) or (Bt, L, D); h0 (D,) shared
    or (Bt, D) per sequence, or None (zeros, nothing read).  Every tensor
    is float32 or bf16, contiguous and on a's device.

    On a CUDA device this is one kernel launch on the current stream; it
    does not synchronise.
    """
    global launches
    if a.dim() not in (2, 3):
        raise ValueError(f"a must be (L, D) or (batch, L, D), got shape "
                         f"{tuple(a.shape)}")
    batched = a.dim() == 3
    Bt = a.shape[0] if batched else 1
    L, D = a.shape[-2:]
    dev = a.device
    _check("a", a, (tuple(a.shape),), dev)
    _check("b", b, (tuple(a.shape),), dev)
    if h0 is not None:
        _check("h0", h0, ((D,),) + (((Bt, D),) if batched else ()), dev)
    if L < 1 or D < 1 or not 1 <= Bt <= MAX_BATCH:
        raise ValueError(f"empty or too large scan: batch {Bt}, L {L}, D {D}")
    if dev.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    refuse_autograd("RG-LRU", a, b, h0)
    if dev.type != "cuda":
        raise ValueError(f"the RG-LRU kernel runs on CUDA tensors, got {dev}")
    y = torch.empty_like(a)
    h_final = torch.empty(a.shape[:-2] + (D,), dtype=a.dtype, device=dev)
    named = {"a": a, "b": b, "h0": h0}
    mask = sum(bit for k, bit in BF16_BITS.items()
               if named[k] is not None and named[k].dtype == torch.bfloat16)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rglru_scan_run(
            a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_final.data_ptr(), Bt, L, D,
            D if h0 is not None and h0.dim() == 2 else 0, mask, stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return y, h_final
