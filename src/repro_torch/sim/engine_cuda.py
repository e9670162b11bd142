"""The lockVM sweep as one CUDA kernel launch (``mode="cuda"``).

Counterpart of the reference's Pallas kernel (``repro/sim/engine_pallas.py``,
``make_run_pallas``).  :func:`run_cells` launches ``csrc/lockvm.cu``: one
thread block of one warp per sweep cell, each running its cell's whole event
loop with each simulated thread's rows in the registers of the lane that
owns it and the shared state in shared memory (or, for a cell too large for
it, in a global scratch buffer allocated here).  The kernel is built with
``nvcc`` at first use (:mod:`repro_torch._build`).

For tensors on the CPU the wrapper runs the plain PyTorch engine, its plain
version; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import engine, isa
from .engine import N_LAT_BUCKETS, OUT_KEYS, bitset_words
from .programs import PROG_LEN

# Shared memory one block may use on Hopper (sm_90): 227 KB.  A cell whose
# state is larger runs from global scratch.
SMEM_LIMIT = 232_448

# Kernel launches made by run_cells (read by chip_smoke.py to show that a
# sweep went through the kernel).
launches = 0


def cell_state_bytes(n_threads: int, mem_words: int, n_locks: int = 1,
                     prog_len: int = PROG_LEN) -> int:
    """Bytes of one cell's state in the kernel (``lvm_layout`` in
    ``csrc/lockvm_step.cuh``): memory, sharer bitsets and dirty owners per
    line, eighteen per-thread rows (eleven of state, seven of the thread's
    next instruction decoded), the register file, the lock table, the
    latency histogram and the program.  The kernel keeps the per-thread rows
    in registers up to 128 threads and reads this copy only above that."""
    n_lines = mem_words // isa.WORDS_PER_SECTOR
    words = (mem_words + n_lines * (bitset_words(n_threads) + 1)
             + n_threads * (18 + isa.N_REGS) + n_locks + N_LAT_BUCKETS
             + prog_len * 5)
    return 4 * words


def _library() -> ctypes.CDLL:
    lib = _build.load_library("lockvm")
    if not getattr(lib, "_lockvm_typed", False):
        lib.lockvm_run.argtypes = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.lockvm_run.restype = ctypes.c_int
        lib.lockvm_state_words.argtypes = [ctypes.c_int] * 4
        lib.lockvm_state_words.restype = ctypes.c_int64
        lib._lockvm_typed = True
    return lib


def state_words_from_kernel(n_threads: int, mem_words: int, n_locks: int,
                            prog_len: int = PROG_LEN) -> int:
    """The kernel's own count of a cell's state words (checks
    :func:`cell_state_bytes` against the compiled layout)."""
    return int(_library().lockvm_state_words(n_threads, mem_words, n_locks,
                                             prog_len))


def run_cells(program, init_pc, init_regs, init_mem, n_active, seed,
              horizon, max_events, costs, wa_base, wa_mask, wa_size,
              faults=None, *, n_locks: int) -> dict:
    """Run a batch of cells, given as int32 tensors, to completion.

    Takes the arguments of :func:`repro_torch.sim.engine.run_cells` (minus
    ``chunk``) and returns :data:`OUT_KEYS` as int32 tensors on the inputs'
    device.  On a CUDA device this is one kernel launch on the current
    stream; it does not synchronise.
    """
    global launches
    dev = program.device
    if dev.type == "cpu":
        return engine.run_cells(program, init_pc, init_regs, init_mem,
                                n_active, seed, horizon, max_events, costs,
                                wa_base, wa_mask, wa_size, faults,
                                n_locks=n_locks)
    if dev.type != "cuda":
        raise ValueError(f"the lockVM kernel runs on CUDA tensors, got {dev}")
    n_cells, n_threads, mem_words = engine._check_cells(
        program, init_pc, init_regs, init_mem, n_active, seed, horizon,
        max_events, costs, wa_base, wa_mask, wa_size, faults, dev)
    prog_len = program.shape[1]
    n_faults = 0 if faults is None else faults[0].shape[1]
    if n_threads < 1 or mem_words < isa.WORDS_PER_SECTOR or n_locks < 1:
        raise ValueError(f"empty cell shape: T={n_threads} M={mem_words} "
                         f"L={n_locks}")
    lib = _library()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    outs = {"acquisitions": empty(n_cells, n_threads),
            "waited_acquisitions": empty(n_cells, n_threads),
            "handover_sum": empty(n_cells), "handover_count": empty(n_cells),
            "events": empty(n_cells), "sleeping": empty(n_cells),
            "grant_value": empty(n_cells, mem_words),
            "lat_hist": empty(n_cells, N_LAT_BUCKETS)}
    state_bytes = cell_state_bytes(n_threads, mem_words, n_locks, prog_len)
    scratch = (None if state_bytes <= SMEM_LIMIT
               else empty(n_cells * state_bytes // 4))
    fault_ptrs = ([f.data_ptr() for f in faults] if n_faults
                  else [None] * 4)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lockvm_run(
            program.data_ptr(), init_pc.data_ptr(), init_regs.data_ptr(),
            init_mem.data_ptr(), n_active.data_ptr(), seed.data_ptr(),
            horizon.data_ptr(), max_events.data_ptr(), costs.data_ptr(),
            wa_base.data_ptr(), wa_mask.data_ptr(), wa_size.data_ptr(),
            *fault_ptrs, *(outs[k].data_ptr() for k in OUT_KEYS),
            None if scratch is None else scratch.data_ptr(),
            n_cells, n_threads, mem_words, n_locks, prog_len, n_faults,
            stream)
    if rc != 0:
        raise RuntimeError(f"lockvm kernel launch failed: CUDA error {rc}")
    launches += 1
    return outs
