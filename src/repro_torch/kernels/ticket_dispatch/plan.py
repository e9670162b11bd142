"""The MoE routing plan as one CUDA kernel launch (``csrc/moe_plan.cu``).

From the router's softmax ``gates_full`` (G, N, E) float32 to every map the
MoE layer's gathers need: the stable top-k, the renormalised gates in the
model's dtype, FIFO tickets and slots, the kept mask, the combine's gather
index, the slot→token map and its mask, and the aux loss's per-group
partials (:func:`repro_torch.kernels.ticket_dispatch.ref.plan_ref` names
them).  :func:`moe_plan` launches one thread block of
:data:`~repro_torch.kernels.ticket_dispatch.kernel.THREADS` threads per
group; the tickets come from the same device function as the standalone
ticket kernel's (``csrc/ticket_dispatch_kernel.cuh``).  The kernel is built
with ``nvcc`` at first use (:mod:`repro_torch._build`).

For tensors on the CPU the wrapper runs the plain version (``plan_ref``);
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import refuse_autograd
from . import kernel, ref

# One lane an expert in the top-k: E <= 32.
MAX_EXPERTS = 32
# Arrivals (token, choice) whose ids a block stages in shared memory at once;
# a longer group is walked in chunks of STAGE // K tokens.
STAGE = 8192
# the gate dtypes the kernel writes, and its flag for bf16
GATE_DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches made by moe_plan (read by chip_smoke.py to show that a
# serve run went through the kernel).
launches = 0


def smem_bytes(n_experts: int, n_tokens: int, top_k: int) -> int:
    """Dynamic shared memory of one block (``mp_smem_bytes``)."""
    warps = kernel.THREADS // 32
    stage = min(n_tokens, STAGE // top_k) * top_k
    return 8 * warps * n_experts + 4 * (warps * n_experts + stage) + \
        kernel.smem_bytes(n_experts)


def _library() -> ctypes.CDLL:
    lib = _build.load_library("moe_plan")
    if not getattr(lib, "_plan_typed", False):
        lib.moe_plan_run.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.moe_plan_run.restype = ctypes.c_int
        lib.moe_plan_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.moe_plan_smem_bytes.restype = ctypes.c_int64
        lib._plan_typed = True
    return lib


def smem_bytes_from_kernel(n_experts: int, n_tokens: int, top_k: int) -> int:
    """The compiled library's own count (checks :func:`smem_bytes`)."""
    return int(_library().moe_plan_smem_bytes(n_experts, n_tokens, top_k))


def moe_plan(gates_full: torch.Tensor, top_k: int, capacity: int,
             gate_dtype: torch.dtype) -> dict:
    """The routing plan of ``gates_full`` (G, N, E) float32, contiguous:
    the dict of :func:`~repro_torch.kernels.ticket_dispatch.ref.plan_ref`.
    On a CUDA device this is one kernel launch on the current stream; it
    does not synchronise."""
    global launches
    if gates_full.dim() != 3:
        raise ValueError(f"gates_full must be (groups, tokens, experts), "
                         f"got shape {tuple(gates_full.shape)}")
    if gates_full.dtype != torch.float32:
        raise TypeError(f"gates_full must be float32, got {gates_full.dtype}")
    if not gates_full.is_contiguous():
        raise ValueError("gates_full must be contiguous")
    G, N, E = gates_full.shape
    if not 0 < E <= MAX_EXPERTS:
        raise ValueError(f"the routing-plan kernel takes 1 to {MAX_EXPERTS} "
                         f"experts (one lane each), got {E}")
    if not 0 < top_k <= E:
        raise ValueError(f"top_k must lie in [1, {E}], got {top_k}")
    if not 0 < capacity <= kernel.INT32_MAX // max(E, 1):
        raise ValueError(f"capacity must lie in [1, 2**31 / E), got "
                         f"{capacity}")
    if N * max(top_k, E) > kernel.INT32_MAX:
        raise ValueError("the routing-plan kernel indexes a group's pairs "
                         "with int32")
    if gate_dtype not in GATE_DTYPES:
        raise TypeError(f"gate_dtype must be one of {GATE_DTYPES}, got "
                        f"{gate_dtype}")
    dev = gates_full.device
    if dev.type == "cpu":
        return ref.plan_ref(gates_full, top_k, capacity, gate_dtype)
    refuse_autograd("routing-plan", gates_full)
    if dev.type != "cuda":
        raise ValueError(f"the routing-plan kernel runs on CUDA tensors, "
                         f"got {dev}")
    K, n_slots = top_k, E * capacity

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {"top_ids": empty((G, N, K), torch.int32),
           "gates": empty((G, N, K), gate_dtype),
           "slot": empty((G, N, K), torch.int32),
           "kept": empty((G, N, K), torch.bool),
           "safe_idx": empty((G, N * K), torch.int64),
           "slot_tok": empty((G, n_slots), torch.int64),
           "valid": empty((G, n_slots), torch.bool),
           "first_counts": empty((G, E), torch.float32),
           "gate_sums": empty((G, E), torch.float32)}
    if G == 0 or N == 0:
        for key in ("slot_tok", "valid", "first_counts", "gate_sums"):
            out[key].zero_()
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.moe_plan_run(
            gates_full.data_ptr(), *(out[k].data_ptr() for k in (
                "top_ids", "gates", "slot", "kept", "safe_idx", "slot_tok",
                "valid", "first_counts", "gate_sums")),
            G, N, E, K, capacity, int(gate_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"moe_plan kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
