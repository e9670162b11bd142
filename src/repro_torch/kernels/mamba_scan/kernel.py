"""The Mamba-1 selective scan as one CUDA kernel launch
(``csrc/mamba_scan.cu``).

Counterpart of the reference's Pallas kernel ``_scan_kernel``
(``repro/kernels/mamba_scan/kernel.py``, wrapper ``selective_scan_pallas``),
with its contract: the inputs are read in their dtypes (float32 or bf16),
h and all arithmetic stay in float32, y and h_final come back in x's dtype.
:func:`selective_scan` launches :data:`LANES` threads per (sequence,
channel), each holding N / LANES of the channel's states in registers for
all L steps, :data:`THREADS` threads a block, with the inputs staged
:data:`CHUNK` steps at a time.  The kernel is built with ``nvcc`` at first
use (:mod:`repro_torch._build`).

For tensors on the CPU the wrapper runs the plain version
(:func:`repro_torch.kernels.mamba_scan.ref.selective_scan_ref`); for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import refuse_autograd
from . import ref

# Threads of one block: THREADS // LANES channels.
THREADS = 128
# Threads per channel, each holding N / LANES of its states: 4, the fastest
# of 2, 4 and 8 at falcon-mamba-7b's prefill on the H100 (PERF.md).
LANES = 4
# Steps of x, dt, B and C staged in shared memory at a time (double
# buffered: 24 KB of static shared memory).
CHUNK = 32
# State sizes the kernel takes (powers of two that divide a warp).
STATE_SIZES = (4, 8, 16)
MAX_BATCH = 65535   # the grid's second dimension

_DTYPES = (torch.float32, torch.bfloat16)
# bit of each input in the kernel's dtype mask (set = bf16)
BF16_BITS = {"x": 1, "dt": 2, "A": 4, "B": 8, "C": 16, "D_skip": 32,
             "h0": 64}

# Kernel launches made by selective_scan (read by chip_smoke.py to show
# that a serve run went through the kernel).
launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.load_library("mamba_scan")
    if not getattr(lib, "_scan_typed", False):
        lib.mamba_scan_run.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 4 + [ctypes.c_int64] * 3 + [
            ctypes.c_uint, ctypes.c_void_p]
        lib.mamba_scan_run.restype = ctypes.c_int
        lib._scan_typed = True
    return lib


def _check(name: str, t: torch.Tensor, shapes: tuple, device) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if tuple(t.shape) not in shapes:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected one "
                         f"of {[list(s) for s in shapes]}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def selective_scan(x, dt, A, B, C, D_skip, h0=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, h_final) of the selective scan; the shapes of
    :func:`ref.selective_scan_ref`: x, dt (L, D) or (Bt, L, D); B, C (L, N)
    or (Bt, L, N); A (D, N) and h0 (D, N) shared or (Bt, D, N) per
    sequence; D_skip (D,) or (Bt, D).  Every tensor is float32 or bf16,
    contiguous and on x's device.  N must be one of :data:`STATE_SIZES`.

    On a CUDA device this is one kernel launch on the current stream; it
    does not synchronise.
    """
    global launches
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (L, D) or (batch, L, D), got shape "
                         f"{tuple(x.shape)}")
    batched = x.dim() == 3
    Bt = x.shape[0] if batched else 1
    L, D = x.shape[-2:]
    if A.dim() not in (2, 3):
        raise ValueError(f"A must be (D, N) or (batch, D, N), got shape "
                         f"{tuple(A.shape)}")
    N = A.shape[-1]
    lead = (Bt,) if batched else ()
    per_seq = ((Bt,),) if batched else ()
    dev = x.device
    _check("x", x, ((*lead, L, D),), dev)
    _check("dt", dt, ((*lead, L, D),), dev)
    _check("A", A, ((D, N),) + tuple(s + (D, N) for s in per_seq), dev)
    _check("B", B, ((*lead, L, N),), dev)
    _check("C", C, ((*lead, L, N),), dev)
    _check("D_skip", D_skip, ((D,),) + tuple(s + (D,) for s in per_seq),
           dev)
    if h0 is not None:
        _check("h0", h0, ((D, N),) + tuple(s + (D, N) for s in per_seq),
               dev)
    if N not in STATE_SIZES:
        raise ValueError(f"state size N={N} is not one the kernel takes: "
                         f"{STATE_SIZES}")
    if L < 1 or D < 1 or not 1 <= Bt <= MAX_BATCH:
        raise ValueError(f"empty or too large scan: batch {Bt}, L {L}, D {D}")
    if dev.type == "cpu":
        return ref.selective_scan_ref(x, dt, A, B, C, D_skip, h0)
    refuse_autograd("selective-scan", x, dt, A, B, C, D_skip, h0)
    if dev.type != "cuda":
        raise ValueError(f"the scan kernel runs on CUDA tensors, got {dev}")
    y = torch.empty_like(x)
    h_final = torch.empty((*lead, D, N), dtype=x.dtype, device=dev)
    named = {"x": x, "dt": dt, "A": A, "B": B, "C": C, "D_skip": D_skip,
             "h0": h0}
    mask = sum(bit for k, bit in BF16_BITS.items()
               if named[k] is not None and named[k].dtype == torch.bfloat16)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mamba_scan_run(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D_skip.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_final.data_ptr(), Bt, L, D, N,
            D * N if A.dim() == 3 else 0, D if D_skip.dim() == 2 else 0,
            D * N if h0 is not None and h0.dim() == 3 else 0, mask, stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return y, h_final
