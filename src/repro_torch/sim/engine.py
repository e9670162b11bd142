"""lockVM engine in PyTorch: the plain event loop and the sweep entry points.

Sequentially-consistent interleaving: a global virtual clock, one event per
step.  Each thread owns an independent timeline (``next_time``); costs charge
the *issuing* thread, so unrelated memory operations proceed in parallel —
except that a store's visibility is delayed by its coherence cost (pending
commit), which is how the invalidation diameter retards handover.

Event kinds:
  * thread op  — fetch program[pc[t]] and execute it.
  * commit     — a delayed store becomes globally visible: memory updated,
                 sharers invalidated, spinners watching the line woken
                 (they pay the refill miss and re-evaluate their condition).

Two implementations of one transition, bit-identical to the JAX reference
engine (``repro.sim.engine``) on every stat:

  * ``mode="torch"`` — :func:`_step`, batched over the B cells of a sweep.
    It keeps the reference's three phases: the fault phase, ONE fused
    argmin over ``[pending-commit times | thread times]``, then an
    :class:`Effects` record applied once.  Every opcode's effect is computed
    for every cell and selected by opcode, as the reference's vmapped
    ``lax.switch`` does; there is no Python loop over cells.  Runs on any
    device; on the CPU it is the only engine.
  * ``mode="cuda"`` — the hand-written kernel in ``csrc/lockvm.cu`` (one
    thread block per cell, state in shared memory), through
    :mod:`repro_torch.sim.engine_cuda`.

Integer semantics.  Every int32 quantity is held in int64 and wrapped to
int32 explicitly after each add, sub and mul (:func:`wrap32`); the uint32
PRNG states and sharer bitset words are int64 masked to 32 bits, and bits
are counted with a SWAR popcount.  Indices taken from program data follow
JAX's rules, not torch's: a gather wraps a negative index once and then
clamps (:func:`gather_index`), a scatter wraps once and then drops the write
(:func:`scatter_index`).  An opcode outside the ISA is clamped into the
handler table exactly as ``lax.switch`` clamps its index.

Entry points (:func:`run_sweep`, :func:`run_sim`) run on ``cuda`` unless the
caller passes ``device="cpu"``; with no GPU and no device they raise.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from . import isa
from .costs import (DEFAULT_COSTS, I_ATOMIC, I_HIT, I_INV, I_LOCAL, I_MISS,
                    I_ST_OWNED, I_ST_SHARED, I_WAKE, I_XFER, Costs)
from .faults import F_ABORT, F_PREEMPT, F_SPURIOUS, FaultSchedule
from .programs import PROG_LEN, pad_program

INF = 1 << 29

# Acquire-latency histogram geometry: bucket k counts samples with
# ``lat >= 2^(k-1)`` and ``lat < 2^k`` (bucket 0 = zero-latency, bucket 31 =
# everything from 2^30 up).  The bucket index is the number of powers of two
# at or below the sample — ``sum(lat >= 2^k for k in 0..30)``.
N_LAT_BUCKETS = 32

log = logging.getLogger(__name__)

# The deterministic event-order contract, verbatim from the reference engine.
EVENT_ORDER_CONTRACT = (
    "one fused argmin over the concatenated [pending-commit times | thread "
    "times] vector, first-minimum wins: a commit/thread-op tie resolves to "
    "the commit, ties within a half resolve to the lowest thread index; "
    "store commits fire at issue_time + store_cost, woken spinners resume "
    "at wake_time + C_WAKE + wake_delay (clearing wake_delay) and re-pay "
    "the refill load on re-execution; when a fault schedule is present, "
    "entries whose event index equals the current event counter are applied "
    "as persisted state mutations BEFORE event selection, gated on the "
    "pre-fault state being live (events < max_events and earliest pre-fault "
    "event time < horizon): a preemption adds K to a running thread's "
    "next_time, or accumulates K into a parked/halted thread's wake_delay; "
    "a spurious wake resumes a parked thread at pre-fault t_min + C_WAKE + "
    "wake_delay (clearing wake_delay and spin_addr, pc unchanged); an abort "
    "sets next_time = INF and spin_addr = -1 (never wakeable); pending "
    "stores are never touched by faults; the event then selects from the "
    "post-fault state — if no post-fault event time is below the horizon, "
    "no event executes and the event counter does not advance"
)

# Result keys, in kernel-output order (the engine's sweep-output contract).
OUT_KEYS = ("acquisitions", "waited_acquisitions", "handover_sum",
            "handover_count", "events", "sleeping", "grant_value",
            "lat_hist")
# Stats compared bit for bit between engines and against the reference.
STAT_KEYS = OUT_KEYS

# Pseudo-opcodes after the ISA: a store commit, and "no event" for a cell
# that is past its horizon or event budget.
OP_COMMIT = isa.N_OPS
OP_NOEVENT = isa.N_OPS + 1

# Plain-engine steps between termination checks (each check syncs a CUDA
# device and compacts finished cells out of the batch).  A step on a
# finished cell is an exact identity, so results do not depend on it.
DEFAULT_TORCH_CHUNK = 16

MASK32 = 0xFFFFFFFF
_I64 = torch.int64


def bitset_words(n_threads: int) -> int:
    """Words in a packed per-line sharer bitset (32 threads per uint32)."""
    return (n_threads + 31) // 32


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement int32 wrap of an int64 tensor (result stays int64)."""
    return ((x + 0x80000000) & MASK32) - 0x80000000


def gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX gather rule: a negative index wraps once, then clamps to [0, n)."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def scatter_index(idx: torch.Tensor, n: int):
    """JAX scatter rule: wrap once, then drop the write if still outside.

    Returns ``(index clamped into range, mask of writes that land)``.
    """
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, n - 1), (idx >= 0) & (idx < n)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2^32) (SWAR; torch has no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


class SimConsts(NamedTuple):
    """Per-cell inputs fixed for the whole run, batched on a leading B axis."""

    program: torch.Tensor     # (B, prog_len, 5)
    costs: torch.Tensor       # (B, 9)
    wa_base: torch.Tensor     # (B,)
    wa_mask: torch.Tensor     # (B,)
    wa_size: torch.Tensor     # (B,)
    horizon: torch.Tensor     # (B,)
    max_events: torch.Tensor  # (B,)
    f_kind: torch.Tensor | None = None  # (B, n_faults); None = fault-free
    f_evt: torch.Tensor | None = None
    f_tid: torch.Tensor | None = None
    f_arg: torch.Tensor | None = None


class SimState(NamedTuple):
    """Full simulator state of one cell, field by field (what
    :func:`debug_states` yields; the engine itself keeps the packed
    :class:`PackedState`)."""

    next_time: np.ndarray   # (T,) per-thread timeline; INF = parked
    pc: np.ndarray          # (T,)
    regs: np.ndarray        # (T, N_REGS)
    prng: np.ndarray        # (T,) uint32 LCG state
    mem: np.ndarray         # (mem_words,)
    sharers: np.ndarray     # (n_lines, ceil(T/32)) uint32 bitset words
    dirty: np.ndarray       # (n_lines,) owning thread or -1
    pend_addr: np.ndarray   # (T,) pending-store address or -1
    pend_val: np.ndarray    # (T,)
    pend_time: np.ndarray   # (T,) commit time of the pending store
    spin_addr: np.ndarray   # (T,) watched address while parked, or -1
    wake_delay: np.ndarray  # (T,) preemption debt paid at the next wake
    acq: np.ndarray         # (T,) lock acquisitions
    waited_acq: np.ndarray  # (T,) acquisitions that had to wait
    rel_time: np.ndarray    # (n_locks,) last REL timestamp or -1
    hand_sum: np.ndarray    # () summed handover latency
    hand_cnt: np.ndarray    # () handovers measured
    events: np.ndarray      # () total events executed
    acq_t0: np.ndarray      # (T,) TSTART mark, -1 = unset
    lat_hist: np.ndarray    # (N_LAT_BUCKETS,) log2 acquire latency


# Per-thread fields of the packed state, in ``PackedState.th[..., f]``.  The
# three a wake rewrites come first so that they form one slice.
TH_NT, TH_SP, TH_WD = 0, 1, 2        # next_time, spin_addr, wake_delay
TH_PC, TH_PRNG, TH_PA, TH_PV, TH_PT = 3, 4, 5, 6, 7
TH_ACQ, TH_WACQ, TH_T0 = 8, 9, 10    # acq, waited_acq, acq_t0
TH_REGS = 11                          # N_REGS registers follow
TH_FIELDS = TH_REGS + isa.N_REGS
# Per-cell scalars, in ``PackedState.cell[:, f]``.
CELL_HS, CELL_HC, CELL_EV = 0, 1, 2   # hand_sum, hand_cnt, events


class PackedState(NamedTuple):
    """The plain engine's state of B cells (int64 tensors, leading B axis).

    Fields that one event reads or writes together are packed together, so
    that a step moves a whole thread row or line row with one gather or
    scatter: per-thread rows (timeline, pc, PRNG, pending store, spin,
    counters and registers), per-line rows (the sharer bitset words, then
    the dirty owner), and the per-cell scalars.  The engine updates it in
    place, one step per event.
    """

    th: torch.Tensor        # (B, T, TH_FIELDS) per-thread rows
    mem: torch.Tensor       # (B, mem_words)
    lines: torch.Tensor     # (B, n_lines, ceil(T/32) + 1) sharers | dirty
    rel_time: torch.Tensor  # (B, n_locks) last REL timestamp or -1
    cell: torch.Tensor      # (B, 3) hand_sum, hand_cnt, events
    lat_hist: torch.Tensor  # (B, N_LAT_BUCKETS) log2 acquire latency


class Effects(NamedTuple):
    """What one event does to each cell: (B,) tensors, one per field.

    "actor" is the executing thread for a program op, or the committing
    thread for a store commit.  Sentinel -1 disables an address/index-valued
    effect.  The reference's register row becomes one register write
    (``reg_val`` into register ``reg_dst`` where ``reg_write``): the row
    differs from the actor's registers in at most that element.
    """

    cost: torch.Tensor
    new_pc: torch.Tensor
    reg_dst: torch.Tensor
    reg_val: torch.Tensor
    reg_write: torch.Tensor
    prng_t: torch.Tensor
    sleep: torch.Tensor
    advance: torch.Tensor
    st_addr: torch.Tensor
    st_val: torch.Tensor
    st_time: torch.Tensor
    clear_pend: torch.Tensor
    w_addr: torch.Tensor
    w_val: torch.Tensor
    excl_ln: torch.Tensor
    share_ln: torch.Tensor
    downgrade: torch.Tensor
    park_addr: torch.Tensor
    wake_addr: torch.Tensor
    wake_time: torch.Tensor
    acq_inc: torch.Tensor
    waited_inc: torch.Tensor
    hand_add: torch.Tensor
    hand_inc: torch.Tensor
    rel_idx: torch.Tensor
    rel_val: torch.Tensor
    t0_new: torch.Tensor
    lat_idx: torch.Tensor


# ---- static per-opcode tables, indexed by the clamped handler index -----
_SPINS = (isa.SPIN_EQ, isa.SPIN_NE, isa.SPIN_EQI, isa.SPIN_NEI, isa.SPIN_GE)
_RMWS = (isa.FADD, isa.SWAP, isa.CASZ)
_BRANCHES = (isa.BEQ, isa.BNE, isa.BLE, isa.BGT, isa.BEQI, isa.BNEI,
             isa.BLEI, isa.BGTI, isa.JMP)
_N_HANDLERS = isa.N_OPS + 2

# boolean properties, one column each
_FLAG_OPS = {
    "loadlike": (isa.LOAD, *_SPINS),   # load cost, registers as a sharer
    "store": (isa.STORE, isa.STOREI),  # delayed store
    "rmw": _RMWS,                      # immediate atomic write
    "spin": _SPINS,
    "branch": _BRANCHES,
    "regw": (isa.LOAD, *_RMWS, isa.ADDI, isa.MOVI, isa.MOV, isa.SUB,
             isa.MULI, isa.ANDI, isa.HASH, isa.HASHP, isa.PRNG),
    "still": (OP_COMMIT, OP_NOEVENT),  # advance = False
    "commit": (OP_COMMIT,),
    "load": (isa.LOAD,),
    "acq": (isa.ACQ,),
    "rel": (isa.REL,),
    "tstart": (isa.TSTART,),
    "halt": (isa.HALT,),
    "prng": (isa.PRNG,),
    "storer": (isa.STORE,),            # stores a register, not a constant
    "rhs_c": (isa.BEQI, isa.BNEI, isa.BLEI, isa.BGTI, isa.SPIN_EQI,
              isa.SPIN_NEI),          # compares against the c field
}
_FLAGS = tuple(_FLAG_OPS)


def _source_table(default: int, groups) -> np.ndarray:
    table = np.full(_N_HANDLERS, default, np.int64)
    for col, ops in groups:
        table[list(ops)] = col
    return table


# which candidate column (see _step) each opcode takes its value from
_COST_SRC = _source_table(0, [(1, (isa.LOAD, *_SPINS)),
                              (2, (isa.STORE, isa.STOREI)), (3, _RMWS),
                              (4, (isa.WORKI,)), (5, (isa.WORKR,)),
                              (6, (isa.HALT,))])
_REG_SRC = _source_table(0, [(1, (isa.PRNG,)), (2, (isa.ADDI,)),
                             (3, (isa.MOVI,)), (4, (isa.MOV,)),
                             (5, (isa.SUB,)), (6, (isa.MULI,)),
                             (7, (isa.ANDI,)), (8, (isa.HASH,)),
                             (9, (isa.HASHP,))])
_COND_SRC = _source_table(4, [
    (0, (isa.BEQ, isa.BEQI, isa.SPIN_EQ, isa.SPIN_EQI)),
    (1, (isa.BNE, isa.BNEI, isa.SPIN_NE, isa.SPIN_NEI)),
    (2, (isa.BLE, isa.BLEI)), (3, (isa.BGT, isa.BGTI)),
    (5, (isa.SPIN_GE,))])


class _Aux(NamedTuple):
    """Per-batch constants of the plain engine (device tensors)."""

    ar: torch.Tensor        # (B,) cell index
    pos: torch.Tensor       # (2T,) position in [commit times | thread times]
    words: torch.Tensor     # (W,) bitset word index
    pow2: torch.Tensor      # (N_LAT_BUCKETS - 1,) 2^k
    flags: torch.Tensor     # (handlers, n_flags) bool
    cost_src: torch.Tensor  # (handlers,)
    reg_src: torch.Tensor
    cond_src: torch.Tensor
    reg_ids: torch.Tensor   # (N_REGS,)


def _aux(n_cells: int, n_threads: int, device) -> _Aux:
    flags = np.zeros((_N_HANDLERS, len(_FLAGS)), bool)
    for j, name in enumerate(_FLAGS):
        flags[list(_FLAG_OPS[name]), j] = True

    def t(x):
        return torch.as_tensor(x, device=device)

    return _Aux(
        ar=torch.arange(n_cells, device=device),
        pos=torch.arange(2 * n_threads, device=device),
        words=torch.arange(bitset_words(n_threads), device=device),
        pow2=torch.bitwise_left_shift(
            torch.ones(N_LAT_BUCKETS - 1, dtype=_I64, device=device),
            torch.arange(N_LAT_BUCKETS - 1, device=device)),
        flags=t(flags), cost_src=t(_COST_SRC), reg_src=t(_REG_SRC),
        cond_src=t(_COND_SRC),
        reg_ids=torch.arange(isa.N_REGS, device=device))


def _pick(cands: list, src: torch.Tensor) -> torch.Tensor:
    """Per cell, the candidate value in column ``src`` (one gather)."""
    return torch.stack(cands, 1).gather(1, src[:, None])[:, 0]


def _fault_phase(c: SimConsts, s: PackedState) -> None:
    """Entries matching the current event counter mutate the timelines
    BEFORE event selection, gated on the pre-fault state being live;
    scatter-adds sum duplicate targets as the reference's do."""
    th = s.th
    n_threads = th.shape[1]
    next_time, spin_addr, wake_delay = th[:, :, TH_NT], th[:, :, TH_SP], \
        th[:, :, TH_WD]
    events = s.cell[:, CELL_EV]
    ptimes = torch.where(th[:, :, TH_PA] >= 0, th[:, :, TH_PT], INF)
    pre_min = torch.minimum(ptimes.min(1).values, next_time.min(1).values)
    flive = (events < c.max_events) & (pre_min < c.horizon)
    tid, tid_ok = scatter_index(c.f_tid, n_threads)
    hit = (flive[:, None] & (c.f_kind != 0) & (c.f_evt == events[:, None])
           & tid_ok)
    zero = torch.zeros_like(next_time)
    k_add = wrap32(zero.scatter_add(
        1, tid, torch.where(hit & (c.f_kind == F_PREEMPT), c.f_arg, 0)))
    running = next_time < INF
    next_time = wrap32(next_time + torch.where(running, k_add, 0))
    wake_delay = wrap32(wake_delay + torch.where(running, 0, k_add))
    spur = zero.scatter_add(
        1, tid, (hit & (c.f_kind == F_SPURIOUS)).long()) > 0
    spur = spur & (spin_addr >= 0)
    next_time = torch.where(
        spur, wrap32(pre_min[:, None] + c.costs[:, I_WAKE, None] + wake_delay),
        next_time)
    wake_delay = torch.where(spur, 0, wake_delay)
    spin_addr = torch.where(spur, -1, spin_addr)
    dead = zero.scatter_add(
        1, tid, (hit & (c.f_kind == F_ABORT)).long()) > 0
    next_time = torch.where(dead, INF, next_time)
    spin_addr = torch.where(dead, -1, spin_addr)
    th[:, :, TH_NT:TH_WD + 1] = torch.stack([next_time, spin_addr,
                                             wake_delay], -1)


def _step(c: SimConsts, s: PackedState, aux: _Aux) -> None:
    """Advance every cell by exactly one event (commit, thread op or none),
    in place.  A cell past its horizon or event budget executes the
    no-event pseudo-op, so the step is an exact identity for it."""
    th = s.th
    n_threads = th.shape[1]
    ar = aux.ar
    C = c.costs

    # ---- fault phase (absent from fault-free runs)
    if c.f_kind is not None:
        _fault_phase(c, s)

    # ---- event selection: one argmin over [commit times | thread times],
    # first minimum wins (a tie goes to the commit half, then to the lowest
    # thread index) — written out rather than trusting argmin's tie order
    ptimes = torch.where(th[:, :, TH_PA] >= 0, th[:, :, TH_PT], INF)
    cat = torch.cat([ptimes, th[:, :, TH_NT]], 1)
    t_min = cat.min(1).values
    k = torch.where(cat == t_min[:, None], aux.pos, 2 * n_threads
                    ).min(1).values
    is_commit = k < n_threads
    tc = k.clamp(max=n_threads - 1)               # commit thread (dead if op)
    t = torch.where(is_commit, 0, k - n_threads)  # op thread (dead if commit)
    live = (s.cell[:, CELL_EV] < c.max_events) & (t_min < c.horizon)
    now = t_min

    # ---- decode: every handler's inputs, for every cell
    row_t = th[ar, t]
    pc_t, prng_t, t0v = row_t[:, TH_PC], row_t[:, TH_PRNG], row_t[:, TH_T0]
    instr = c.program[ar, gather_index(pc_t, c.program.shape[1])]
    op, b, cc, imm = instr[:, 0], instr[:, 2], instr[:, 3], instr[:, 4]
    ra, rb, rc = row_t[:, TH_REGS:].gather(
        1, gather_index(instr[:, 1:4], isa.N_REGS)).unbind(1)
    br = torch.where(live, torch.where(is_commit, OP_COMMIT,
                                       op.clamp(0, OP_NOEVENT)), OP_NOEVENT)
    f = dict(zip(_FLAGS, aux.flags[br].unbind(1)))

    # memory operand and coherence costs
    addr = wrap32(torch.where(f["store"], ra, rb) + imm)
    ln = addr >> isa.LINE_SHIFT
    n_lines, n_words = s.lines.shape[1], s.lines.shape[2] - 1
    line = s.lines[ar, gather_index(ln, n_lines)]          # (B, W + 1)
    t_bit = torch.bitwise_left_shift(torch.ones_like(t), t & 31)
    mine = (line.gather(1, (t >> 5)[:, None])[:, 0] & t_bit) != 0
    d = line[:, n_words]
    foreign = (d >= 0) & (d != t)
    load_cost = torch.where(mine, C[:, I_HIT],
                            torch.where(foreign, C[:, I_XFER], C[:, I_MISS]))
    others = popcount32(line[:, :n_words]).sum(1) - mine.long()
    store_cost = wrap32(torch.where(
        mine & (others == 0), C[:, I_ST_OWNED],
        C[:, I_ST_SHARED] + C[:, I_INV] * others))
    rmw_cost = wrap32(store_cost + C[:, I_ATOMIC])
    memv = s.mem[ar, gather_index(addr, s.mem.shape[1])]

    # register results (the PRNG is a uint32 LCG held in int64)
    sd = (prng_t * 1664525 + 1013904223) & MASK32
    rb127 = wrap32(rb * 127)
    reg_val = wrap32(_pick(
        [memv, (sd >> 16) % imm.clamp(min=1), rb + imm, imm, rb, rb - rc,
         rb * imm, rb & imm, c.wa_base + ((rb127 ^ rc) & c.wa_mask),
         c.wa_base + rc * c.wa_size + (rb127 & c.wa_mask)], aux.reg_src[br]))

    # branch and spin conditions
    lhs = torch.where(f["spin"], memv, ra)
    rhs = torch.where(f["rhs_c"], cc, torch.where(f["spin"], ra, rb))
    cond = _pick([lhs == rhs, lhs != rhs, lhs <= rhs, lhs > rhs,
                  torch.ones_like(lhs, dtype=torch.bool),
                  wrap32(memv - ra) >= 0], aux.cond_src[br])
    parks = f["spin"] & ~cond
    new_pc = torch.where(f["branch"] & cond, imm, wrap32(pc_t + 1))
    new_pc = torch.where(parks | f["halt"], pc_t, new_pc)

    # ACQ: handover and acquire-latency bookkeeping
    rt = s.rel_time[ar, gather_index(ra, s.rel_time.shape[1])]
    waited = f["acq"] & (cc > 0)
    got = waited & (rt >= 0)
    marked = f["acq"] & (t0v >= 0)
    bucket = (wrap32(now - t0v).clamp(min=0)[:, None] >= aux.pow2).sum(1)

    # store commit (pseudo-op): the selected thread's pending store; an RMW
    # writes, wakes and takes its line exactly like a commit does
    row_tc = th[ar, tc]
    w_addr = torch.where(f["rmw"], addr, torch.where(
        f["commit"], row_tc[:, TH_PA], -1))
    none = torch.full_like(t, -1)
    e = Effects(
        cost=_pick([C[:, I_LOCAL], load_cost, store_cost, rmw_cost,
                    imm.clamp(min=1), ra.clamp(min=1),
                    torch.full_like(t, INF)], aux.cost_src[br]),
        new_pc=new_pc,
        reg_dst=instr[:, 1],
        reg_val=reg_val,
        reg_write=f["regw"],
        prng_t=torch.where(f["prng"], sd, prng_t),
        sleep=parks,
        advance=~f["still"],
        st_addr=torch.where(f["store"], addr, none),
        st_val=torch.where(f["storer"], rb, b),
        st_time=wrap32(now + store_cost),
        clear_pend=f["commit"],
        w_addr=w_addr,
        w_val=torch.where(f["rmw"], _pick(
            [wrap32(memv + cc), rc, torch.where(memv == rc, 0, memv)],
            (op - isa.FADD).clamp(0, 2)), row_tc[:, TH_PV]),
        excl_ln=w_addr >> isa.LINE_SHIFT,
        share_ln=torch.where(f["loadlike"], ln, none),
        downgrade=f["load"] & ~mine & foreign,
        park_addr=torch.where(parks, addr, none),
        wake_addr=w_addr,
        wake_time=torch.where(f["rmw"], wrap32(now + rmw_cost), now),
        acq_inc=f["acq"],
        waited_inc=waited,
        hand_add=torch.where(got, wrap32(now - rt), 0),
        hand_inc=got,
        rel_idx=torch.where(f["acq"], ra, torch.where(f["rel"], rb, none)),
        rel_val=torch.where(f["acq"], torch.where(got, -1, rt), now),
        t0_new=torch.where(marked, -1, torch.where(f["tstart"], now, -2)),
        lat_idx=torch.where(marked, bucket, none),
    )
    _apply(c, s, aux, e, live, torch.where(is_commit, tc, t), now)


def _apply(c: SimConsts, s: PackedState, aux: _Aux, e: Effects, live,
           actor, now) -> None:
    """Apply phase: every state update happens exactly once, in the
    reference's order (wake, then the actor's own park/advance, which wins
    over a wake; sharer registration before the exclusive grab)."""
    th, ar = s.th, aux.ar
    n_regs = isa.N_REGS

    # wake watchers of the written address; a woken thread pays any
    # preemption debt accrued while parked on top of C_WAKE
    wake = ((e.wake_addr >= 0)[:, None]
            & (th[:, :, TH_SP] == e.wake_addr[:, None]))
    woken = torch.stack(torch.broadcast_tensors(
        wrap32(e.wake_time[:, None] + c.costs[:, I_WAKE, None]
               + th[:, :, TH_WD]), torch.tensor(-1, device=ar.device),
        torch.tensor(0, device=ar.device)), -1)
    th[:, :, TH_NT:TH_WD + 1] = torch.where(wake[:, :, None], woken,
                                            th[:, :, TH_NT:TH_WD + 1])

    # the actor's row: park / advance, pending store, counters, registers
    adv = e.advance
    row = th[ar, actor]
    st = e.st_addr >= 0
    yes = torch.ones_like(adv)
    dst, dst_ok = scatter_index(e.reg_dst, n_regs)
    values = torch.stack([
        torch.where(e.sleep, INF, wrap32(now + e.cost)),   # TH_NT
        e.park_addr,                                       # TH_SP
        row[:, TH_WD],                                     # TH_WD
        e.new_pc,                                          # TH_PC
        e.prng_t,                                          # TH_PRNG
        torch.where(st, e.st_addr, -1),                    # TH_PA
        e.st_val,                                          # TH_PV
        e.st_time,                                         # TH_PT
        wrap32(row[:, TH_ACQ] + e.acq_inc.long()),         # TH_ACQ
        wrap32(row[:, TH_WACQ] + e.waited_inc.long()),     # TH_WACQ
        e.t0_new,                                          # TH_T0
    ], 1)
    take = torch.stack([adv, e.park_addr >= 0, ~yes, adv, adv,
                        st | e.clear_pend, st, st, yes, yes,
                        e.t0_new != -2], 1)
    take_reg = ((aux.reg_ids[None, :] == dst[:, None])
                & (adv & e.reg_write & dst_ok)[:, None])
    th[ar, actor] = torch.where(
        torch.cat([take, take_reg], 1),
        torch.cat([values, e.reg_val[:, None].expand(-1, n_regs)], 1), row)

    # immediate memory write (RMW / commit)
    mem_words = s.mem.shape[1]
    w_ok = (e.w_addr >= 0) & (e.w_addr < mem_words)
    wi = e.w_addr.clamp(0, mem_words - 1)
    s.mem[ar, wi] = torch.where(w_ok, e.w_val, s.mem[ar, wi])

    # sharer registration (+ downgrade of a foreign dirty line): OR the
    # actor's bit into its bitset word; then the exclusive grab (RMW /
    # commit): the row collapses to the actor's lone bit, dirty = actor
    n_lines, n_words = s.lines.shape[1], s.lines.shape[2] - 1
    a_bits = torch.where(
        aux.words[None, :] == (actor >> 5)[:, None],
        torch.bitwise_left_shift(torch.ones_like(actor), actor & 31
                                 )[:, None], 0)
    s_ok = (e.share_ln >= 0) & (e.share_ln < n_lines)
    si = e.share_ln.clamp(0, n_lines - 1)
    line = s.lines[ar, si]
    shared = torch.cat([line[:, :n_words] | a_bits, torch.where(
        e.downgrade, -1, line[:, n_words])[:, None]], 1)
    s.lines[ar, si] = torch.where(s_ok[:, None], shared, line)
    x_ok = (e.excl_ln >= 0) & (e.excl_ln < n_lines)
    xi = e.excl_ln.clamp(0, n_lines - 1)
    s.lines[ar, xi] = torch.where(x_ok[:, None], torch.cat(
        [a_bits, actor[:, None]], 1), s.lines[ar, xi])

    # lock bookkeeping
    n_locks = s.rel_time.shape[1]
    r_ok = (e.rel_idx >= 0) & (e.rel_idx < n_locks)
    ri = e.rel_idx.clamp(0, n_locks - 1)
    s.rel_time[ar, ri] = torch.where(r_ok, e.rel_val, s.rel_time[ar, ri])
    li = e.lat_idx.clamp(0, N_LAT_BUCKETS - 1)
    s.lat_hist[ar, li] += (e.lat_idx >= 0).long()
    s.cell.copy_(wrap32(s.cell + torch.stack(
        [e.hand_add, e.hand_inc.long(), live.long()], 1)))


def _initial_state(n_threads: int, mem_words: int, n_locks: int,
                   init_pc, init_regs, init_mem, n_active,
                   seed) -> PackedState:
    """Batched initial state; every argument carries the leading B axis."""
    n_cells = init_pc.shape[0]
    dev = init_pc.device
    n_lines = mem_words // isa.WORDS_PER_SECTOR
    lane_t = torch.arange(n_threads, dtype=_I64, device=dev)[None, :]
    th = torch.zeros((n_cells, n_threads, TH_FIELDS), dtype=_I64, device=dev)
    th[:, :, TH_NT] = torch.where(lane_t < n_active.long()[:, None], 0, INF)
    th[:, :, TH_SP] = -1
    th[:, :, TH_PC] = init_pc.long()
    th[:, :, TH_PRNG] = ((seed.long()[:, None] & MASK32)
                         + lane_t * 2654435761) & MASK32
    th[:, :, TH_PA] = -1
    th[:, :, TH_T0] = -1
    th[:, :, TH_REGS:] = init_regs.long()
    lines = torch.zeros((n_cells, n_lines, bitset_words(n_threads) + 1),
                        dtype=_I64, device=dev)
    lines[:, :, -1] = -1
    return PackedState(
        th=th, mem=init_mem.long().clone(), lines=lines,
        rel_time=torch.full((n_cells, n_locks), -1, dtype=_I64, device=dev),
        cell=torch.zeros((n_cells, 3), dtype=_I64, device=dev),
        lat_hist=torch.zeros((n_cells, N_LAT_BUCKETS), dtype=_I64,
                             device=dev))


def _live(c: SimConsts, s: PackedState) -> torch.Tensor:
    """The single-cell loop condition (the reference's), per cell."""
    t_th = s.th[:, :, TH_NT].min(1).values
    t_cm = torch.where(s.th[:, :, TH_PA] >= 0, s.th[:, :, TH_PT],
                       INF).min(1).values
    return ((s.cell[:, CELL_EV] < c.max_events)
            & (torch.minimum(t_th, t_cm) < c.horizon))


def _outputs(s: PackedState) -> dict:
    return {
        "acquisitions": s.th[:, :, TH_ACQ],
        "waited_acquisitions": s.th[:, :, TH_WACQ],
        "handover_sum": s.cell[:, CELL_HS],
        "handover_count": s.cell[:, CELL_HC],
        "events": s.cell[:, CELL_EV],
        "sleeping": (s.th[:, :, TH_SP] >= 0).sum(1),
        "grant_value": s.mem, "lat_hist": s.lat_hist,
    }


def _unpack(s: PackedState, i: int) -> SimState:
    """Cell ``i`` of a packed state, field by field, as numpy arrays (copies:
    the engine goes on updating ``s`` in place)."""

    def np_(x):
        return x[i].cpu().numpy().copy()

    th, lines, cell = np_(s.th), np_(s.lines), np_(s.cell)
    return SimState(
        next_time=th[:, TH_NT], pc=th[:, TH_PC], regs=th[:, TH_REGS:],
        prng=th[:, TH_PRNG], mem=np_(s.mem),
        sharers=lines[:, :-1], dirty=lines[:, -1], pend_addr=th[:, TH_PA],
        pend_val=th[:, TH_PV], pend_time=th[:, TH_PT],
        spin_addr=th[:, TH_SP], wake_delay=th[:, TH_WD], acq=th[:, TH_ACQ],
        waited_acq=th[:, TH_WACQ], rel_time=np_(s.rel_time),
        hand_sum=cell[CELL_HS], hand_cnt=cell[CELL_HC],
        events=cell[CELL_EV], acq_t0=th[:, TH_T0],
        lat_hist=np_(s.lat_hist))


def _check_cells(program, init_pc, init_regs, init_mem, n_active, seed,
                 horizon, max_events, costs, wa_base, wa_mask, wa_size,
                 faults, device) -> tuple[int, int, int]:
    """Validate the batched int32 input tensors; return (B, T, M)."""
    n_cells, n_threads = init_pc.shape
    mem_words = init_mem.shape[1]
    shapes = {
        "program": (program, (n_cells, program.shape[1], 5)),
        "init_pc": (init_pc, (n_cells, n_threads)),
        "init_regs": (init_regs, (n_cells, n_threads, isa.N_REGS)),
        "init_mem": (init_mem, (n_cells, mem_words)),
        "costs": (costs, (n_cells, 9)),
    }
    for name, x in (("n_active", n_active), ("seed", seed),
                    ("horizon", horizon), ("max_events", max_events),
                    ("wa_base", wa_base), ("wa_mask", wa_mask),
                    ("wa_size", wa_size)):
        shapes[name] = (x, (n_cells,))
    if faults is not None:
        if len(faults) != 4:
            raise ValueError(f"faults must be 4 arrays, got {len(faults)}")
        n_faults = faults[0].shape[1]
        for name, x in zip(("f_kind", "f_evt", "f_tid", "f_arg"), faults):
            shapes[name] = (x, (n_cells, n_faults))
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {x.dtype} != torch.int32")
        if x.device != device:
            raise ValueError(f"{name}: on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if mem_words % isa.WORDS_PER_SECTOR:
        raise ValueError(f"mem_words {mem_words} is not a whole number of "
                         f"{isa.WORDS_PER_SECTOR}-word lines")
    return n_cells, n_threads, mem_words


def run_cells(program, init_pc, init_regs, init_mem, n_active, seed,
              horizon, max_events, costs, wa_base, wa_mask, wa_size,
              faults=None, *, n_locks: int, chunk: int | None = None) -> dict:
    """The plain engine over a batch of cells given as int32 tensors.

    The same signature as the CUDA kernel's wrapper
    (:func:`repro_torch.sim.engine_cuda.run_cells`), so the two can be held
    against each other on one set of inputs.  ``seed`` carries the uint32
    seeds' bit patterns.  Returns :data:`OUT_KEYS` as int32 tensors on the
    inputs' device.  Runs every cell until the single-cell loop's stop
    condition, checking it every ``chunk`` steps and dropping finished cells
    from the batch.
    """
    chunk = DEFAULT_TORCH_CHUNK if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    n_cells, n_threads, mem_words = _check_cells(
        program, init_pc, init_regs, init_mem, n_active, seed, horizon,
        max_events, costs, wa_base, wa_mask, wa_size, faults, program.device)
    fault_fields = {}
    if faults is not None:
        fault_fields = dict(zip(("f_kind", "f_evt", "f_tid", "f_arg"),
                                (f.long() for f in faults)))
    c = SimConsts(program=program.long(), costs=costs.long(),
                  wa_base=wa_base.long(), wa_mask=wa_mask.long(),
                  wa_size=wa_size.long(), horizon=horizon.long(),
                  max_events=max_events.long(), **fault_fields)
    s = _initial_state(n_threads, mem_words, n_locks, init_pc, init_regs,
                       init_mem, n_active, seed)
    outs = {k: torch.zeros_like(v) for k, v in _outputs(s).items()}
    cells = torch.arange(n_cells, device=program.device)
    aux = _aux(n_cells, n_threads, program.device)
    while True:
        for _ in range(chunk):
            _step(c, s, aux)
        live = _live(c, s)
        done = ~live
        if bool(done.any()):
            for k, v in _outputs(s).items():
                outs[k][cells[done]] = v[done]
            if not bool(live.any()):
                break
            cells = cells[live]
            c = SimConsts(*(None if x is None else x[live] for x in c))
            s = PackedState(*(x[live] for x in s))
            aux = _aux(len(cells), n_threads, program.device)
    return {k: v.to(torch.int32) for k, v in outs.items()}


def choose_mode(device) -> str:
    """The engine ``mode="auto"`` picks: the CUDA kernel on a CUDA device,
    the plain engine on the CPU."""
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        return "cuda"
    if dev_type == "cpu":
        return "torch"
    raise ValueError(f"no lockVM engine for device type {dev_type!r}")


def _fault_arrays(faults) -> tuple:
    """Normalize a faults argument to a tuple of four (n_faults,) arrays."""
    if faults is None:
        return ()
    if isinstance(faults, FaultSchedule):
        faults = faults.padded(max(len(faults), 1))
    fk, fe, ft, fa = (np.asarray(a, np.int32) for a in faults)
    assert fk.shape == fe.shape == ft.shape == fa.shape and fk.ndim == 1, \
        (fk.shape, fe.shape, ft.shape, fa.shape)
    return (fk, fe, ft, fa)


def _broadcast_cells(x, n_cells: int, dtype) -> np.ndarray:
    arr = np.asarray(x, dtype)
    if arr.ndim == 0:
        arr = np.full(n_cells, arr, dtype)
    assert arr.shape == (n_cells,), (arr.shape, n_cells)
    return arr


def run_sim(program: np.ndarray, *, n_threads: int, mem_words: int,
            n_locks: int, init_pc: np.ndarray, init_regs: np.ndarray,
            wa_base: int, wa_size: int, horizon: int = 2_000_000,
            max_events: int = 2_000_000, seed: int = 1,
            costs: Costs = DEFAULT_COSTS, init_mem: np.ndarray | None = None,
            n_active: int | None = None, faults=None, device=None) -> dict:
    """Run a single lockVM program; returns python-side stats.

    A one-cell :func:`run_sweep`.  ``faults`` is an optional
    :class:`~repro_torch.sim.faults.FaultSchedule` (or a 4-tuple of
    ``(n_faults,)`` int32 arrays).
    """
    assert wa_size & (wa_size - 1) == 0
    if init_mem is None:
        init_mem = np.zeros(mem_words, np.int32)
    if n_active is None:
        n_active = n_threads
    if isinstance(costs, Costs):
        costs = costs.to_array()
    fault_args = _fault_arrays(faults)
    out = run_sweep(
        pad_program(program, PROG_LEN)[None], mem_words=mem_words,
        n_locks=n_locks, init_pc=np.asarray(init_pc)[None],
        init_regs=np.asarray(init_regs)[None],
        n_active=n_active, seeds=np.uint32(seed), wa_base=wa_base,
        wa_size=wa_size, horizon=horizon, max_events=max_events,
        costs=np.asarray(costs, np.int32)[None],
        init_mem=np.asarray(init_mem)[None],
        faults=tuple(a[None] for a in fault_args) if fault_args else None,
        device=device)
    res = {k: out[k][0] for k in OUT_KEYS if k != "grant_value"}
    res["mem"] = out["grant_value"][0]
    res["horizon"] = horizon
    res["throughput"] = float(res["acquisitions"].sum()) / horizon
    hc = int(res["handover_count"])
    res["avg_handover"] = float(res["handover_sum"]) / hc if hc else float("nan")
    res["mode"] = out["mode"]
    return res


def debug_states(program: np.ndarray, *, n_threads: int, mem_words: int,
                 n_locks: int, init_pc: np.ndarray, init_regs: np.ndarray,
                 wa_base: int, wa_size: int, horizon: int,
                 max_events: int = 2_000_000, seed: int = 1,
                 costs: Costs | np.ndarray = DEFAULT_COSTS,
                 init_mem: np.ndarray | None = None,
                 n_active: int | None = None, faults=None, device=None):
    """Single-cell debug entry: yield the full :class:`SimState` (one cell,
    as numpy int64 arrays) after EVERY event, in the engine's own order.

    The loop condition is the engine's (``events < max_events`` and the
    earliest event time below ``horizon``), so the last state yielded is
    the final state of :func:`run_sim` bit for bit.  One step per event —
    use small horizons.
    """
    assert wa_size & (wa_size - 1) == 0
    dev = resolve_device(device)
    if isinstance(costs, Costs):
        costs = costs.to_array()
    if init_mem is None:
        init_mem = np.zeros(mem_words, np.int32)
    if n_active is None:
        n_active = n_threads

    def t64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    fault_fields = {k: t64(v)[None] for k, v in zip(
        ("f_kind", "f_evt", "f_tid", "f_arg"), _fault_arrays(faults))}
    c = SimConsts(program=t64(pad_program(program))[None],
                  costs=t64(costs)[None], wa_base=t64([wa_base]),
                  wa_mask=t64([wa_size - 1]), wa_size=t64([wa_size]),
                  horizon=t64([horizon]), max_events=t64([max_events]),
                  **fault_fields)
    s = _initial_state(n_threads, mem_words, n_locks, t64(init_pc)[None],
                       t64(init_regs)[None], t64(init_mem)[None],
                       t64([n_active]), t64([np.uint32(seed)]))
    aux = _aux(1, n_threads, dev)
    while bool(_live(c, s)[0]):
        _step(c, s, aux)
        yield _unpack(s, 0)


def sweep_inputs(programs: np.ndarray, *, mem_words: int,
                 init_pc: np.ndarray, init_regs: np.ndarray, n_active, seeds,
                 wa_base, wa_size, horizon, max_events=2_000_000, costs=None,
                 init_mem: np.ndarray | None = None, faults=None,
                 device) -> tuple:
    """The int32 tensors :func:`run_cells` (and the kernel's wrapper) take,
    built from :func:`run_sweep`'s numpy arguments on ``device``: programs,
    init pc/regs/mem, n_active, seed bit patterns, horizon, max_events,
    costs, wa_base, wa_mask, wa_size and the fault arrays (or None)."""
    programs = np.asarray(programs, np.int32)
    assert programs.ndim == 3 and programs.shape[2] == 5, programs.shape
    n_cells = programs.shape[0]
    init_pc = np.asarray(init_pc, np.int32)
    init_regs = np.asarray(init_regs, np.int32)
    n_threads = init_pc.shape[1]
    assert init_pc.shape == (n_cells, n_threads)
    assert init_regs.shape[:2] == (n_cells, n_threads)
    wa_size_arr = _broadcast_cells(wa_size, n_cells, np.int32)
    assert (wa_size_arr & (wa_size_arr - 1) == 0).all(), "wa_size must be pow2"
    if costs is None:
        costs = DEFAULT_COSTS
    if isinstance(costs, Costs):
        costs = costs.to_array()
    costs = np.asarray(costs, np.int32)
    if costs.ndim == 1:
        costs = np.broadcast_to(costs, (n_cells, 9))
    if init_mem is None:
        init_mem = np.zeros((n_cells, mem_words), np.int32)
    init_mem = np.asarray(init_mem, np.int32)
    assert init_mem.shape == (n_cells, mem_words), init_mem.shape
    if faults is not None:
        faults = tuple(np.asarray(a, np.int32) for a in faults)
        assert len(faults) == 4, len(faults)
        for a in faults:
            assert a.shape == (n_cells, faults[0].shape[1]), a.shape

    def t32(x):
        return torch.as_tensor(np.array(x, np.int32, order="C"),
                               device=device)

    return (t32(programs), t32(init_pc), t32(init_regs), t32(init_mem),
            t32(_broadcast_cells(n_active, n_cells, np.int32)),
            t32(_broadcast_cells(seeds, n_cells, np.uint32).view(np.int32)),
            t32(_broadcast_cells(horizon, n_cells, np.int32)),
            t32(_broadcast_cells(max_events, n_cells, np.int32)),
            t32(costs),
            t32(_broadcast_cells(wa_base, n_cells, np.int32)),
            t32(wa_size_arr - 1), t32(wa_size_arr),
            None if faults is None else tuple(t32(a) for a in faults))


def run_sweep(programs: np.ndarray, *, mem_words: int, n_locks: int,
              init_pc: np.ndarray, init_regs: np.ndarray,
              n_active, seeds, wa_base, wa_size,
              horizon, max_events=2_000_000, costs=None,
              init_mem: np.ndarray | None = None,
              mode: str = "auto", chunk: int | None = None,
              live_mem_words=None, faults=None, device=None) -> dict:
    """Run a batch of independent simulations in one call.

    Every per-cell argument carries a leading batch axis of size B; scalars
    broadcast.  All cells share the padded shapes ``(n_threads, mem_words,
    n_locks, prog_len)``; padded threads are marked inactive via
    ``n_active``.  The arguments are the reference engine's
    (``repro.sim.engine.run_sweep``) numpy arrays, with these differences:

      mode:   "cuda" runs the hand-written kernel (a CUDA device only),
        "torch" the plain PyTorch engine (any device), "auto" picks by
        device (:func:`choose_mode`).  Results are bit-identical.
      chunk:  "torch" only — steps between termination checks.
      device: where to run; default ``cuda``, and with no GPU present and
        no device given the call raises.

    Returns a dict of stacked numpy arrays: per-thread stats (B, n_threads),
    scalars (B,), ``grant_value`` (B, mem_words) and ``lat_hist``
    (B, N_LAT_BUCKETS); plus ``mode`` (the resolved engine) and
    ``pad_stats`` (the sweep's padding-waste report).
    """
    programs = np.asarray(programs, np.int32)
    dev = resolve_device(device)
    if mode == "auto":
        mode = choose_mode(dev)
        log.info("run_sweep mode='auto' -> %r (device=%s, B=%d, "
                 "n_threads=%d, mem_words=%d)", mode, dev, programs.shape[0],
                 np.shape(init_pc)[1], mem_words)
    if mode not in ("torch", "cuda"):
        raise ValueError(f"mode must be 'auto', 'torch' or 'cuda', "
                         f"got {mode!r}")
    if mode == "cuda" and dev.type != "cuda":
        raise ValueError(f"mode='cuda' runs the CUDA kernel and needs a CUDA "
                         f"device, got device={str(dev)!r}")
    if mode == "cuda" and chunk is not None:
        raise ValueError("chunk only applies to mode='torch'")
    args = sweep_inputs(
        programs, mem_words=mem_words, init_pc=init_pc, init_regs=init_regs,
        n_active=n_active, seeds=seeds, wa_base=wa_base, wa_size=wa_size,
        horizon=horizon, max_events=max_events, costs=costs,
        init_mem=init_mem, faults=faults, device=dev)
    if mode == "cuda":
        from .engine_cuda import run_cells as run_kernel
        out = run_kernel(*args, n_locks=n_locks)
    else:
        out = run_cells(*args, n_locks=n_locks, chunk=chunk)
    res = {k: out[k].cpu().numpy() for k in OUT_KEYS}
    res["mode"] = mode
    n_cells, n_threads = np.shape(init_pc)
    res["pad_stats"] = _pad_stats(
        programs, _broadcast_cells(n_active, n_cells, np.int32), n_threads,
        res["events"],
        _broadcast_cells(mem_words if live_mem_words is None
                         else live_mem_words, n_cells, np.int64), mem_words)
    return res


def _pad_stats(programs: np.ndarray, n_active: np.ndarray, n_threads: int,
               events: np.ndarray, live_mem: np.ndarray,
               mem_words: int) -> dict:
    """Padding-waste report for one sweep dispatch: the live fractions of
    the padded batch's threads, program rows and memory words."""
    n_cells, prog_len = programs.shape[0], programs.shape[1]
    # live program rows: everything up to the last row that is not the
    # canonical (HALT, 0, 0, 0, 0) pad row pad_program appends
    pad_row = ((programs[:, :, 0] == isa.HALT)
               & (programs[:, :, 1:] == 0).all(-1))
    live = ~pad_row
    live_rows = np.where(live.any(axis=1),
                         prog_len - np.argmax(live[:, ::-1], axis=1), 0)
    return {
        "sum_events": int(events.sum()),
        "max_events": int(events.max()) if n_cells else 0,
        "live_thread_frac": float(n_active.sum() / (n_cells * n_threads)),
        "live_prog_frac": float(live_rows.sum() / (n_cells * prog_len)),
        "live_mem_frac": float(live_mem.sum() / (n_cells * mem_words)),
    }
