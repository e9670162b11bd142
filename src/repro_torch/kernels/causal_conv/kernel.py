"""The Mamba-1 mixer's causal depthwise conv, its bias and its SiLU as one
CUDA kernel launch (``csrc/causal_conv.cu``).

It replaces no TPU kernel: the reference's conv is plain XLA.  Its bound is
bytes (x read once, y written once), and its design is a stream: each
thread owns :data:`CHANNELS` consecutive channels and walks a run of
positions in order, the window's last kw-1 rows in registers,
:data:`UNROLL` rows in flight ahead; :func:`run_length` picks the run from
the shape.  x is read in place through its strides, so the
in-projection's ``chunk`` view is never copied.  The outputs are
``silu(conv(x) + b)`` (B, S, d) and the tail (B, kw-1, d), contiguous, in
x's dtype, rounded where :func:`ref.causal_conv_ref` rounds: the conv's
sum over k = 0 .. kw-1 in float32, then the bias, then the SiLU.  The plain
version's einsum may add in another order: bit for bit where the order
agrees, else within :func:`repro_torch.bench.kernel_pair.conv_bound`.  The
kernel is built with ``nvcc`` at first use (:mod:`repro_torch._build`).

For tensors on the CPU the wrapper runs the plain version; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import refuse_autograd
from . import ref

THREADS = 128      # threads of one block, one channel group each
CHANNELS = 4       # consecutive channels of a thread
UNROLL = 2         # rows a thread has in flight ahead of the one it computes
WIDTHS = (2, 3, 4)  # conv widths the kernel takes
# Runs a power of two from MAX_RUN down to MIN_RUN positions: the longest
# that still gives each SM FILL threads.
MIN_RUN, MAX_RUN, FILL = 4, 32, 1024
MAX_BATCH = 65535   # the grid's third dimension
MAX_RUNS = 65535    # ... and its second

_DTYPES = (torch.float32, torch.bfloat16)
# bits of the kernel's flags word: bf16 (else float32); x's rows, the
# parameters, the outputs' rows on 16-byte boundaries
FLAG_BITS = {"bf16": 1, "vec_x": 2, "vec_p": 4, "vec_y": 8}

# Kernel launches made by causal_conv (read by chip_smoke.py to show that a
# serve run went through the kernel).
launches = 0

_sms: dict[int, int] = {}


def _library() -> ctypes.CDLL:
    lib = _build.load_library("causal_conv")
    if not getattr(lib, "_conv_typed", False):
        lib.causal_conv_run.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 4 + [ctypes.c_int64] * 2 + [
            ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
        lib.causal_conv_run.restype = ctypes.c_int
        lib._conv_typed = True
    return lib


def run_length(batch: int, S: int, d: int, sms: int = 132) -> int:
    """Positions a thread walks: the longest power of two from
    :data:`MAX_RUN` down to :data:`MIN_RUN` that gives ``sms`` SMs
    :data:`FILL` threads each, so that a long prompt pays little for each
    run's halo and a short one still keeps every SM's loads in flight."""
    groups = -(-d // CHANNELS)
    run = MAX_RUN
    while run > MIN_RUN and batch * groups * -(-S // run) < sms * FILL:
        run //= 2
    return run


def flags(x, w, b) -> int:
    """The kernel's flags word for these tensors (``FLAG_BITS``): the dtype,
    and whether each of x's rows, w and b, and the outputs' rows (d
    elements apart) start on 16-byte boundaries."""
    esize = x.element_size()
    sb = x.stride(0) if x.shape[0] > 1 else 0
    aligned = (x.data_ptr() % 16 == 0 and x.stride(1) * esize % 16 == 0
               and sb * esize % 16 == 0)
    return (FLAG_BITS["bf16"] * (x.dtype == torch.bfloat16)
            + FLAG_BITS["vec_x"] * aligned
            + FLAG_BITS["vec_p"] * (w.data_ptr() % 16 == 0
                                    and b.data_ptr() % 16 == 0)
            + FLAG_BITS["vec_y"] * (x.shape[2] * esize % 16 == 0))


def check(x, w, b) -> None:
    """Raise unless x (B, S, d) with unit channel stride, w (d, kw) and b
    (d,) contiguous, all of one dtype (float32 or bf16) on one device, kw
    one of :data:`WIDTHS`, within the grid's limits."""
    if x.dim() != 3:
        raise ValueError(f"x must be (batch, S, d), got shape "
                         f"{tuple(x.shape)}")
    Bt, S, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("w", w), ("b", b)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must be x's dtype {x.dtype}, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w.dim() != 2 or w.shape[0] != d or w.shape[1] not in WIDTHS:
        raise ValueError(f"w has shape {tuple(w.shape)}, expected ({d}, kw) "
                         f"with kw one of {WIDTHS}")
    if tuple(b.shape) != (d,):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected ({d},)")
    if x.stride(2) != 1 and d > 1:
        raise ValueError("x's channels must be contiguous (stride 1), got "
                         f"strides {x.stride()}")
    if S < 1 or d < 1 or not 1 <= Bt <= MAX_BATCH:
        raise ValueError(f"empty or too large conv: batch {Bt}, S {S}, "
                         f"d {d}")


def causal_conv(x, w, b) -> tuple[torch.Tensor, torch.Tensor]:
    """(silu(conv(x) + b), tail) — the shapes of
    :func:`ref.causal_conv_ref`; x may be a strided view (its channels
    contiguous), w and b contiguous, all of x's dtype and device.

    On a CUDA device this is one kernel launch on the current stream; it
    does not synchronise.
    """
    global launches
    check(x, w, b)
    if x.device.type == "cpu":
        return ref.causal_conv_ref(x, w, b)
    refuse_autograd("causal-conv", x, w, b)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the conv kernel runs on CUDA tensors, got {dev}")
    Bt, S, d = x.shape
    kw = w.shape[1]
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    run = run_length(Bt, S, d, _sms[index])
    if -(-S // run) > MAX_RUNS:
        raise ValueError(f"S {S} needs more than {MAX_RUNS} runs")
    y = torch.empty((Bt, S, d), dtype=x.dtype, device=dev)
    tail = torch.empty((Bt, kw - 1, d), dtype=x.dtype, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.causal_conv_run(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            tail.data_ptr(), Bt, S, d, kw, x.stride(0), x.stride(1), run,
            flags(x, w, b), stream)
    if rc != 0:
        raise RuntimeError(f"causal_conv kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return y, tail
