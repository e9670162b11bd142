"""Run the device code of the port's CUDA kernels on the host, with ``g++``.

The lockVM kernel's event loop (``csrc/lockvm_step.cuh``), the selective
scan's and the RG-LRU scan's block functions (``csrc/mamba_scan_kernel.cuh``,
``csrc/rglru_scan_kernel.cuh``), the ticket kernel's group function
(``csrc/ticket_dispatch_kernel.cuh``), the MoE routing-plan kernel's
(``csrc/moe_plan_kernel.cuh``) and the causal conv's thread function
(``csrc/causal_conv_kernel.cuh``) use only a few CUDA built-ins (warp
shuffles, votes, matches and reductions, ``__syncwarp``, ``__syncthreads``,
bit casts, ``expf``, rounded arithmetic, the bf16 cast).  ``csrc/rehearse/warp_emu.h``
defines them for the host: each GPU thread becomes a ``std::thread``, and
every warp or block primitive a ``std::barrier`` phase.  A small program
per kernel (``csrc/rehearse/<name>_host.cpp``) includes the header with the
same generated constants header the ``nvcc`` build uses
(:mod:`repro_torch._build`), runs it on inputs given as a file of int32
words and writes its outputs the same way.  Tests hold those outputs
against the plain PyTorch versions, so the kernels' logic is checked on any
machine with ``g++``, without a card.

Programs are built once per source hash into ``<build dir>/rehearse``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import _build

HOST_SRC = _build.CSRC / "rehearse"

# program name -> (its source, the kernel headers it includes, header maker)
PROGRAMS = {
    "lockvm": ("lockvm_host.cpp", ("lockvm_step.cuh",),
               _build.constants_header),
    "mamba_scan": ("mamba_scan_host.cpp", ("mamba_scan_kernel.cuh",),
                   _build.mamba_constants_header),
    "rglru_scan": ("rglru_scan_host.cpp", ("rglru_scan_kernel.cuh",),
                   _build.rglru_constants_header),
    "ticket_dispatch": ("ticket_dispatch_host.cpp",
                        ("ticket_dispatch_kernel.cuh",),
                        _build.ticket_constants_header),
    "moe_plan": ("moe_plan_host.cpp",
                 ("moe_plan_kernel.cuh", "ticket_dispatch_kernel.cuh"),
                 _build.plan_constants_header),
    "causal_conv": ("causal_conv_host.cpp", ("causal_conv_kernel.cuh",),
                    _build.conv_constants_header),
}


def gxx_path() -> str | None:
    """``g++`` from ``PATH``, or None."""
    return shutil.which("g++")


def build(name: str) -> Path:
    """Build the rehearsal program ``name`` (once per source hash)."""
    source, kernel_headers, make_header = PROGRAMS[name]
    gxx = gxx_path()
    if gxx is None:
        raise RuntimeError("g++ not found: the rehearsal programs are built "
                           "from source")
    header_text = make_header()
    digest = hashlib.sha256(header_text.encode())
    for path in (HOST_SRC / source, HOST_SRC / "warp_emu.h",
                 *(_build.CSRC / h for h in kernel_headers)):
        digest.update(path.read_bytes())
    tag = digest.hexdigest()[:16]
    out_dir = _build.build_dir() / "rehearse"
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = out_dir / f"{name}_host-{tag}"
    if exe.exists():
        return exe
    header = out_dir / f"{name}-{tag}_consts.h"
    header.write_text(header_text)
    fd, tmp = tempfile.mkstemp(dir=out_dir)
    os.close(fd)
    cmd = [gxx, "-std=c++20", "-O2", "-pthread", "-include", str(header),
           "-I", str(_build.CSRC), "-I", str(HOST_SRC), "-o", tmp,
           str(HOST_SRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.chmod(tmp, 0o755)
    os.replace(tmp, exe)
    return exe


def _run(name: str, words: list[np.ndarray], args=(),
         timeout: float = 300) -> np.ndarray:
    """Run program ``name`` on the int32 words given; its output words."""
    exe = build(name)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.bin", Path(tmp) / "out.bin"
        np.concatenate([np.asarray(w).reshape(-1).view(np.int32)
                        for w in words]).tofile(src)
        proc = subprocess.run([str(exe), str(src), str(dst),
                               *map(str, args)], capture_output=True,
                              text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"{exe.name} failed ({proc.returncode}): "
                               f"{proc.stderr}")
        return np.fromfile(dst, dtype=np.int32)


def lockvm_run_cells(program, init_pc, init_regs, init_mem, n_active, seed,
                     horizon, max_events, costs, wa_base, wa_mask, wa_size,
                     faults=None, *, n_locks: int, tpl: int | None = None
                     ) -> dict:
    """The lockVM kernel's event loop on the host: the arguments of
    :func:`repro_torch.sim.engine_cuda.run_cells` (int32 CPU tensors), its
    outputs (:data:`~repro_torch.sim.engine.OUT_KEYS`, int32 tensors).
    ``tpl`` forces the rows' variant (1, 2 or 4 slots a lane in registers,
    0 in memory); None chooses as ``lockvm.cu`` does."""
    from .sim.engine import N_LAT_BUCKETS, OUT_KEYS

    B, P = program.shape[:2]
    T, M = init_pc.shape[1], init_mem.shape[1]
    F = 0 if faults is None else faults[0].shape[1]
    arrays = [program, init_pc, init_regs, init_mem, n_active, seed, horizon,
              max_events, costs, wa_base, wa_mask, wa_size,
              *(faults if F else ())]
    words = [np.array([B, T, M, n_locks, P, F], np.int32)]
    words += [a.cpu().numpy().astype(np.int32) for a in arrays]
    out = _run("lockvm", words, () if tpl is None else (tpl,))
    shapes = {"acquisitions": (B, T), "waited_acquisitions": (B, T),
              "handover_sum": (B,), "handover_count": (B,), "events": (B,),
              "sleeping": (B,), "grant_value": (B, M),
              "lat_hist": (B, N_LAT_BUCKETS)}
    result, at = {}, 0
    for key in OUT_KEYS:
        n = int(np.prod(shapes[key]))
        result[key] = torch.from_numpy(out[at:at + n].reshape(shapes[key])
                                       .copy())
        at += n
    assert at == out.size, (at, out.size)
    return result


def _raw_words(t: torch.Tensor) -> np.ndarray:
    """A float32 or bf16 tensor's bytes as int32 words (zero-padded)."""
    raw = t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                              else torch.int32).numpy().tobytes()
    raw += b"\0" * (-len(raw) % 4)
    return np.frombuffer(raw, dtype=np.int32)


def _from_words(words: np.ndarray, n: int, dtype: torch.dtype, shape
                ) -> torch.Tensor:
    """The first n elements of dtype (float32 or bf16) packed in words."""
    esize = 2 if dtype == torch.bfloat16 else 4
    raw = words.tobytes()[:n * esize]
    as_int = torch.int16 if esize == 2 else torch.int32
    return (torch.frombuffer(bytearray(raw), dtype=as_int).view(dtype)
            .reshape(shape))


def rglru_scan(a, b, h0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU kernel's device code on the host: the arguments of
    :func:`repro_torch.kernels.rglru.kernel.rglru_scan` (CPU tensors,
    float32 or bf16 each), its (y, h_final) in a's dtype."""
    from .kernels.rglru import kernel

    batched = a.dim() == 3
    Bt = a.shape[0] if batched else 1
    L, D = a.shape[-2:]
    named = {"a": a, "b": b, "h0": h0}
    mask = sum(bit for k, bit in kernel.BF16_BITS.items()
               if named[k] is not None and named[k].dtype == torch.bfloat16)
    head = [Bt, L, D, D if h0 is not None and h0.dim() == 2 else 0, mask,
            int(h0 is not None)]
    words = [np.array(head, np.int32)]
    words += [_raw_words(t) for t in (a, b, h0) if t is not None]
    out = _run("rglru_scan", words)
    lead = (Bt,) if batched else ()
    esize = 2 if a.dtype == torch.bfloat16 else 4
    wy = (Bt * L * D * esize + 3) // 4
    return (_from_words(out[:wy], Bt * L * D, a.dtype, (*lead, L, D)),
            _from_words(out[wy:], Bt * D, a.dtype, (*lead, D)))


def ticket_dispatch(expert_ids: torch.Tensor, n_experts: int,
                    capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ticket kernel's device code on the host: (tickets, slots) of a
    (G, n) int32 CPU tensor of expert ids, as
    :func:`repro_torch.kernels.ticket_dispatch.kernel.ticket_dispatch`."""
    G, n = expert_ids.shape
    words = [np.array([G, n, n_experts, capacity], np.int32),
             expert_ids.numpy().astype(np.int32)]
    out = _run("ticket_dispatch", words)
    tickets, slots = out.reshape(2, G, n)
    return torch.from_numpy(tickets.copy()), torch.from_numpy(slots.copy())


def moe_plan(gates_full: torch.Tensor, top_k: int, capacity: int,
             gate_dtype: torch.dtype) -> dict:
    """The routing-plan kernel's device code on the host: the arguments of
    :func:`repro_torch.kernels.ticket_dispatch.plan.moe_plan` (a CPU
    tensor), its dict of outputs."""
    G, N, E = gates_full.shape
    bf16 = gate_dtype == torch.bfloat16
    words = [np.array([G, N, E, top_k, capacity, int(bf16)], np.int32),
             _raw_words(gates_full.float())]
    out = _run("moe_plan", words).tobytes()
    n_slots = E * capacity
    layout = [("top_ids", torch.int32, (G, N, top_k)),
              ("gates", gate_dtype, (G, N, top_k)),
              ("slot", torch.int32, (G, N, top_k)),
              ("kept", torch.bool, (G, N, top_k)),
              ("safe_idx", torch.int64, (G, N * top_k)),
              ("slot_tok", torch.int64, (G, n_slots)),
              ("valid", torch.bool, (G, n_slots)),
              ("first_counts", torch.float32, (G, E)),
              ("gate_sums", torch.float32, (G, E))]
    result, at = {}, 0
    for key, dtype, shape in layout:
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        result[key] = (torch.frombuffer(bytearray(out[at:at + n]),
                                        dtype=torch.uint8)
                       .view(dtype).reshape(shape))
        at += (n + 3) // 4 * 4
    assert at == len(out), (at, len(out))
    return result


def mamba_scan(x, dt, A, B, C, D_skip, h0=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective-scan kernel's block function on the host: the
    arguments of :func:`repro_torch.kernels.mamba_scan.kernel
    .selective_scan` (CPU tensors, float32 or bf16 each), its (y,
    h_final) in x's dtype."""
    from .kernels.mamba_scan import kernel

    batched = x.dim() == 3
    Bt = x.shape[0] if batched else 1
    L, D = x.shape[-2:]
    N = A.shape[-1]
    named = {"x": x, "dt": dt, "A": A, "B": B, "C": C, "D_skip": D_skip,
             "h0": h0}
    mask = sum(bit for k, bit in kernel.BF16_BITS.items()
               if named[k] is not None and named[k].dtype == torch.bfloat16)
    head = [Bt, L, D, N, D * N if A.dim() == 3 else 0,
            D if D_skip.dim() == 2 else 0,
            D * N if h0 is not None and h0.dim() == 3 else 0, mask,
            int(h0 is not None)]
    words = [np.array(head, np.int32)]
    words += [_raw_words(t) for t in (x, dt, A, B, C, D_skip, h0)
              if t is not None]
    out = _run("mamba_scan", words)
    lead = (Bt,) if batched else ()
    ny, nh = Bt * L * D, Bt * D * N
    esize = 2 if x.dtype == torch.bfloat16 else 4
    wy = (ny * esize + 3) // 4
    return (_from_words(out[:wy], ny, x.dtype, (*lead, L, D)),
            _from_words(out[wy:], nh, x.dtype, (*lead, D, N)))


def causal_conv(x, w, b, run: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The causal conv kernel's thread function on the host: the arguments
    of :func:`repro_torch.kernels.causal_conv.kernel.causal_conv` (CPU
    tensors; x may be a strided view), its (y, tail) in x's dtype.  ``run``
    forces the positions a thread walks; None chooses as the wrapper does
    for 132 SMs."""
    from .kernels.causal_conv import kernel

    kernel.check(x, w, b)
    Bt, S, d = x.shape
    kw = w.shape[1]
    run = kernel.run_length(Bt, S, d) if run is None else run
    sb, sr = x.stride(0), x.stride(1)
    nx = (Bt - 1) * sb + (S - 1) * sr + d
    span = x.as_strided((nx,), (1,))     # from x's first element
    head = [Bt, S, d, kw, sb, sr, run, kernel.flags(x, w, b), nx]
    words = [np.array(head, np.int32)]
    words += [_raw_words(t) for t in (span, w, b)]
    out = _run("causal_conv", words)
    ny, nt = Bt * S * d, Bt * (kw - 1) * d
    esize = x.element_size()
    wy = (ny * esize + 3) // 4
    return (_from_words(out[:wy], ny, x.dtype, (Bt, S, d)),
            _from_words(out[wy:], nt, x.dtype, (Bt, kw - 1, d)))
