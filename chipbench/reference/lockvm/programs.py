"""lockVM programs: lock algorithms (paper Listing 1 + appendix variants +
MCS baseline) and the MutexBench loop built around them.

A frozen copy of the part of the program's ``repro_torch.sim`` module of
this name that the benchmark's cells reach, kept beside the benchmark as
its yardstick.

Memory map (words; one sector = 16 words = 128 modeled bytes):
  [0 .. n_locks*LOCK_STRIDE)              lock regions (sector-aligned fields)
  [node_base .. +n_threads*32)            MCS queue nodes (flag/next sectors)
  [wa_base .. +wa_total)                  waiting array (shared or per-lock)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .isa import (ACQ, ADDI, ANDI, Asm, BEQ, BEQI, BGTI, BLEI, BNEI, CASZ,
                  CC_FUTILE, CC_WAKES, FADD, HASH, HASHP, JMP, LOAD,
                  MCS_FLAG, MCS_NEXT, MCS_NODE_STRIDE, LOCK_STRIDE, MOV, MOVI,
                  MULI, N_REGS, OFF_GRANT, OFF_LGRANT, OFF_PGRANTS, OFF_RD,
                  OFF_TAIL, OFF_TICKET, PRNG, REL, R_AT, R_DX, R_G, R_K,
                  R_LIDX, R_LOCK, R_NODE, R_NX, R_T1, R_T2, R_TID, R_TX, R_U,
                  R_V, R_W, R_Z, SPIN_EQ, SPIN_EQI, SPIN_GE, SPIN_NE,
                  SPIN_NEI, STORE, STOREI, SUB, SWAP, TSTART,
                  WORDS_PER_SECTOR, WORKI, WORKR)

LT_THRESHOLD = 1  # the paper's LongTermThreshold (default; Layout overrides)


@dataclass
class Layout:
    n_threads: int
    n_locks: int
    wa_size: int = 4096
    private_arrays: bool = False  # Fig-2 idealized per-lock arrays
    long_term_threshold: int = LT_THRESHOLD  # TWA-family waiting split point
    sem_permits: int = 4          # twa-sem counting-semaphore capacity
    reader_fraction: int = 50     # twa-rw: percent of acquisitions that are
    #                               reads (0 = writer-only, 100 = read-only)
    count_collisions: bool = False  # TWA family: tally wakeups in node words
    timo_patience: int = 24       # twa-timo: poll iterations before abandoning

    @property
    def node_base(self) -> int:
        return self.n_locks * LOCK_STRIDE

    @property
    def wa_base(self) -> int:
        base = self.node_base + self.n_threads * MCS_NODE_STRIDE
        return (base + WORDS_PER_SECTOR - 1) // WORDS_PER_SECTOR * WORDS_PER_SECTOR

    @property
    def mem_words(self) -> int:
        n_arrays = self.n_locks if self.private_arrays else 1
        w = self.wa_base + self.wa_size * n_arrays
        return (w + WORDS_PER_SECTOR - 1) // WORDS_PER_SECTOR * WORDS_PER_SECTOR


# --------------------------------------------------------------------------
# Lock code generators.  Each emits acquire code falling through to an ACQ
# marker and release code; the workload wraps them in a loop.  `asm.emit`
# order matches the paper's Listing 1.
# --------------------------------------------------------------------------

def _hash_op(layout: Layout):
    """HASH for the shared array, HASHP (per-lock offset) for private arrays."""
    return HASHP if layout.private_arrays else HASH


def gen_ticket_acquire(asm: Asm, tag: str) -> None:
    asm.emit(FADD, R_TX, R_LOCK, 1, OFF_TICKET)
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)
    asm.emit(BEQ, R_TX, R_G, 0, f"{tag}_fast")
    asm.emit(SPIN_EQ, R_TX, R_LOCK, 0, OFF_GRANT)
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_fast")
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_in")


def gen_ticket_release(asm: Asm, tag: str) -> None:
    asm.emit(ADDI, R_K, R_TX, 0, 1)
    asm.emit(REL, 0, R_LIDX, 0, 0)
    asm.emit(STORE, R_LOCK, R_K, 0, OFF_GRANT)  # non-atomic increment


def _emit_wakeup_tally(asm: Asm, tag: str, thr: int, frontier: int) -> None:
    """Collision instrumentation for a TWA-family long-term loop.

    Emitted right after the loop's SPIN, i.e. executed once per wakeup.  Two
    counters live in the thread's OWN node sector (never shared, so the
    stores cost C_STORE_OWNED and wake nobody): total wakeups, and futile
    wakeups — the slot changed but the grant is still more than ``thr`` past
    ``frontier``, so the notify was a hash collision meant for another ticket
    (paper §3).  A legitimate wakeup short-circuits to the ``_st`` stage.
    """
    asm.emit(LOAD, R_V, R_NODE, 0, CC_WAKES)
    asm.emit(ADDI, R_V, R_V, 0, 1)
    asm.emit(STORE, R_NODE, R_V, 0, CC_WAKES)
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)
    asm.emit(SUB, R_DX, R_TX, R_G)
    asm.emit(BLEI, R_DX, 0, frontier + thr, f"{tag}_st")
    asm.emit(LOAD, R_V, R_NODE, 0, CC_FUTILE)
    asm.emit(ADDI, R_V, R_V, 0, 1)
    asm.emit(STORE, R_NODE, R_V, 0, CC_FUTILE)


def gen_twa_acquire(asm: Asm, tag: str, layout: Layout) -> None:
    _emit_twa_ticket_wait(asm, tag, layout, fast_label=f"{tag}_fast",
                          tally=layout.count_collisions)
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_fast")
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_in")


def gen_twa_release(asm: Asm, tag: str, layout: Layout) -> None:
    # restore_z=False: nothing in the twa program reads R_Z after the
    # notify, and the historical 6-op release sequence is what the fig8/
    # fig9 calibrations were tuned on
    _emit_twa_ticket_pass(asm, tag, layout, rel=True, restore_z=False)


def gen_mcs_acquire(asm: Asm, tag: str) -> None:
    asm.emit(STOREI, R_NODE, 1, 0, MCS_FLAG)    # locked = 1
    asm.emit(STOREI, R_NODE, 0, 0, MCS_NEXT)    # next = null(0)
    asm.emit(SWAP, R_T1, R_LOCK, R_NODE, OFF_TAIL)
    asm.emit(BEQI, R_T1, 0, 0, f"{tag}_fast")
    asm.emit(STORE, R_T1, R_NODE, 0, MCS_NEXT)  # pred.next = me
    asm.emit(SPIN_EQI, 0, R_NODE, 0, MCS_FLAG)  # local spin on own flag
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_fast")
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_in")


def gen_mcs_release(asm: Asm, tag: str) -> None:
    asm.emit(LOAD, R_NX, R_NODE, 0, MCS_NEXT)
    asm.emit(BNEI, R_NX, 0, 0, f"{tag}_succ")
    asm.emit(CASZ, R_T1, R_LOCK, R_NODE, OFF_TAIL)   # try detach
    asm.emit(BEQ, R_T1, R_NODE, 0, f"{tag}_done")
    asm.emit(SPIN_NEI, 0, R_NODE, 0, MCS_NEXT)       # successor mid-enqueue
    asm.emit(LOAD, R_NX, R_NODE, 0, MCS_NEXT)
    asm.label(f"{tag}_succ")
    asm.emit(REL, 0, R_LIDX, 0, 0)
    asm.emit(STORE, R_NX, R_Z, 0, MCS_FLAG)          # R_Z == 0 by convention
    asm.label(f"{tag}_done")


def gen_tkt_dual_acquire(asm: Asm, tag: str,
                         thr: int = LT_THRESHOLD) -> None:
    asm.emit(FADD, R_TX, R_LOCK, 1, OFF_TICKET)
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)
    asm.emit(SUB, R_DX, R_TX, R_G)
    asm.emit(BEQI, R_DX, 0, 0, f"{tag}_fast")
    asm.emit(BLEI, R_DX, 0, thr, f"{tag}_st")
    asm.label(f"{tag}_lt")                       # long-term: spin on lgrant
    asm.emit(LOAD, R_U, R_LOCK, 0, OFF_LGRANT)
    asm.emit(SUB, R_DX, R_TX, R_U)
    asm.emit(BLEI, R_DX, 0, thr, f"{tag}_st")
    asm.emit(SPIN_NE, R_U, R_LOCK, 0, OFF_LGRANT)
    asm.emit(JMP, 0, 0, 0, f"{tag}_lt")
    asm.label(f"{tag}_st")
    asm.emit(SPIN_EQ, R_TX, R_LOCK, 0, OFF_GRANT)
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_fast")
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_in")


def gen_tkt_dual_release(asm: Asm, tag: str) -> None:
    asm.emit(ADDI, R_K, R_TX, 0, 1)
    asm.emit(REL, 0, R_LIDX, 0, 0)
    asm.emit(STORE, R_LOCK, R_K, 0, OFF_GRANT)   # short-term handover first
    asm.emit(STORE, R_LOCK, R_K, 0, OFF_LGRANT)  # then shift long-term


def gen_twa_id_acquire(asm: Asm, tag: str, layout: Layout) -> None:
    thr = layout.long_term_threshold
    asm.emit(FADD, R_TX, R_LOCK, 1, OFF_TICKET)
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)
    asm.emit(SUB, R_DX, R_TX, R_G)
    asm.emit(BEQI, R_DX, 0, 0, f"{tag}_fast")
    asm.emit(BLEI, R_DX, 0, thr, f"{tag}_st")
    asm.emit(_hash_op(layout), R_AT, R_TX, R_LIDX if layout.private_arrays else R_LOCK)
    asm.emit(STORE, R_AT, R_T2, 0, 0)            # write identity (R_T2=tid+1)
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)    # recheck
    asm.emit(SUB, R_DX, R_TX, R_G)
    asm.emit(BLEI, R_DX, 0, thr, f"{tag}_st")
    asm.emit(SPIN_NE, R_T2, R_AT, 0, 0)          # until slot != my identity
    asm.label(f"{tag}_st")
    asm.emit(SPIN_EQ, R_TX, R_LOCK, 0, OFF_GRANT)
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_fast")
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_in")


def gen_twa_id_release(asm: Asm, tag: str, layout: Layout) -> None:
    asm.emit(ADDI, R_K, R_TX, 0, 1)
    asm.emit(REL, 0, R_LIDX, 0, 0)
    asm.emit(STORE, R_LOCK, R_K, 0, OFF_GRANT)
    asm.emit(ADDI, R_T1, R_K, 0, layout.long_term_threshold)
    asm.emit(_hash_op(layout), R_AT, R_T1, R_LIDX if layout.private_arrays else R_LOCK)
    asm.emit(STORE, R_AT, R_Z, 0, 0)             # plain store of 0 — no RMW


def gen_twa_staged_acquire(asm: Asm, tag: str, layout: Layout) -> None:
    """TWA-Staged (appendix): (A) ≥3 away parks on the array; (B) 2 away
    busy-waits on grant and, on reaching the front region, promotes the next
    (A) thread itself; (C) the immediate successor spins on grant.  Unlock
    never touches the array.

    Liveness note (beyond the appendix's sketch): a thread can transition
    (A)→owner-adjacent in one wakeup if two handovers land between its
    notify and its recheck, skipping the (B) observation the appendix relies
    on.  Every dx ≥ 2 entrant therefore performs the promotion exactly once
    when it first observes dx ≤ 1 — over-notification is benign (spurious
    recheck), a lost promotion deadlocks the chain.
    """
    asm.emit(FADD, R_TX, R_LOCK, 1, OFF_TICKET)
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)
    asm.emit(SUB, R_DX, R_TX, R_G)
    asm.emit(BEQI, R_DX, 0, 0, f"{tag}_fast")
    asm.emit(BLEI, R_DX, 0, 1, f"{tag}_c")           # (C): no duty
    asm.emit(BLEI, R_DX, 0, 2, f"{tag}_b")           # (B): skip the park
    # (A): long-term waiting, threshold 2
    asm.emit(_hash_op(layout), R_AT, R_TX, R_LIDX if layout.private_arrays else R_LOCK)
    asm.label(f"{tag}_lt")
    asm.emit(LOAD, R_U, R_AT, 0, 0)
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)        # recheck grant (races)
    asm.emit(SUB, R_DX, R_TX, R_G)
    asm.emit(BLEI, R_DX, 0, 2, f"{tag}_b")
    asm.emit(SPIN_NE, R_U, R_AT, 0, 0)
    asm.emit(JMP, 0, 0, 0, f"{tag}_lt")
    asm.label(f"{tag}_b")                            # (B): wait for dx <= 1
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)
    asm.emit(SUB, R_DX, R_TX, R_G)
    asm.emit(BLEI, R_DX, 0, 1, f"{tag}_promote")
    asm.emit(SPIN_NE, R_G, R_LOCK, 0, OFF_GRANT)     # sleep till grant moves
    asm.emit(JMP, 0, 0, 0, f"{tag}_b")
    asm.label(f"{tag}_promote")                      # duty: wake (A) successor
    asm.emit(ADDI, R_T1, R_TX, 0, 1)
    asm.emit(_hash_op(layout), R_AT, R_T1, R_LIDX if layout.private_arrays else R_LOCK)
    asm.emit(FADD, R_Z, R_AT, 1, 0)                  # atomic notify
    asm.emit(MOVI, R_Z, 0, 0, 0)                     # restore R_Z == 0
    asm.label(f"{tag}_c")                            # (C): classic spin
    asm.emit(SPIN_EQ, R_TX, R_LOCK, 0, OFF_GRANT)
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_fast")
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_in")


def _emit_add(asm: Asm, dst: int, src_a: int, src_b: int) -> None:
    """rd = ra + rb via two SUBs (the ISA has reg-reg SUB only; R_Z == 0)."""
    asm.emit(SUB, R_V, R_Z, src_b)   # R_V = -src_b
    asm.emit(SUB, dst, src_a, R_V)   # dst = a + b


def gen_partitioned_acquire(asm: Asm, tag: str) -> None:
    asm.emit(FADD, R_TX, R_LOCK, 1, OFF_TICKET)
    asm.emit(ANDI, R_T1, R_TX, 0, 15)
    asm.emit(MULI, R_T1, R_T1, 0, WORDS_PER_SECTOR)
    _emit_add(asm, R_AT, R_LOCK, R_T1)
    asm.emit(LOAD, R_G, R_AT, 0, OFF_PGRANTS)
    asm.emit(BEQ, R_G, R_TX, 0, f"{tag}_fast")
    asm.emit(SPIN_EQ, R_TX, R_AT, 0, OFF_PGRANTS)
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_fast")
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_in")


def gen_partitioned_release(asm: Asm, tag: str) -> None:
    asm.emit(ADDI, R_K, R_TX, 0, 1)
    asm.emit(ANDI, R_T1, R_K, 0, 15)
    asm.emit(MULI, R_T1, R_T1, 0, WORDS_PER_SECTOR)
    _emit_add(asm, R_AT, R_LOCK, R_T1)
    asm.emit(REL, 0, R_LIDX, 0, 0)
    asm.emit(STORE, R_AT, R_K, 0, OFF_PGRANTS)


def gen_anderson_acquire(asm: Asm, tag: str, layout: Layout) -> None:
    """Anderson's array-based queue lock on the lockVM.

    Boolean flags live in the waiting-array region, one slot per ticket via
    the TWA hash: ×127 is a unit modulo ``wa_size``, so the ≤ n_threads
    concurrent tickets (which span far less than ``wa_size``) never collide —
    the hash serves as Anderson's ``tx % size`` slot map with the sector
    spreading thrown in for free.  Flag convention: nonzero = "go"; the
    winner zeroes its slot on entry (consume) so the slot is clean when
    ticket tx + wa_size wraps around to it.
    """
    asm.emit(FADD, R_TX, R_LOCK, 1, OFF_TICKET)
    asm.emit(_hash_op(layout), R_AT, R_TX,
             R_LIDX if layout.private_arrays else R_LOCK)
    asm.emit(LOAD, R_U, R_AT, 0, 0)
    asm.emit(BNEI, R_U, 0, 0, f"{tag}_fast")     # flag already granted
    asm.emit(SPIN_NEI, 0, R_AT, 0, 0)            # park till my flag != 0
    asm.emit(STOREI, R_AT, 0, 0, 0)              # consume the grant
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_fast")
    asm.emit(STOREI, R_AT, 0, 0, 0)
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_in")


def gen_anderson_release(asm: Asm, tag: str, layout: Layout) -> None:
    asm.emit(ADDI, R_K, R_TX, 0, 1)
    asm.emit(_hash_op(layout), R_AT, R_K,
             R_LIDX if layout.private_arrays else R_LOCK)
    asm.emit(REL, 0, R_LIDX, 0, 0)
    asm.emit(STOREI, R_AT, 1, 0, 0)              # flags[next] = 1 (handover)


def gen_clh_acquire(asm: Asm, tag: str) -> None:
    """CLH queue lock: swap into the tail, spin on the PREDECESSOR's node.

    Each thread owns one single-word cell (its node sector, word 0 = the CLH
    "locked" flag).  Release recycles: the predecessor's now-free node becomes
    this thread's node for the next acquisition — the classic CLH rotation —
    so after k handovers a thread may well be spinning on a cell another
    thread allocated.  The tail starts at a per-lock sentinel whose flag is 0
    (see :func:`clh_init_mem`), which is what makes the first SWAP's
    predecessor immediately grantable.
    """
    asm.emit(STOREI, R_NODE, 1, 0, MCS_FLAG)         # my.locked = 1
    asm.emit(SWAP, R_T1, R_LOCK, R_NODE, OFF_TAIL)   # pred = XCHG(tail, me)
    asm.emit(LOAD, R_U, R_T1, 0, MCS_FLAG)
    asm.emit(BEQI, R_U, 0, 0, f"{tag}_fast")         # pred already unlocked
    asm.emit(SPIN_EQI, 0, R_T1, 0, MCS_FLAG)         # spin on pred's cell
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_fast")
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_in")


def gen_clh_release(asm: Asm, tag: str) -> None:
    asm.emit(REL, 0, R_LIDX, 0, 0)
    asm.emit(STOREI, R_NODE, 0, 0, MCS_FLAG)         # handover: my.locked = 0
    asm.emit(MOV, R_NODE, R_T1)                      # recycle pred's node


def clh_init_mem(layout: Layout) -> np.ndarray:
    """CLH tail starts at a per-lock sentinel node with locked == 0.

    The sentinel borrows the lock region's OFF_PGRANTS sector (only the
    partitioned lock uses those words, and a program is exactly one lock
    algorithm), so no extra memory layout is needed.
    """
    mem = np.zeros(layout.mem_words, np.int32)
    for lidx in range(layout.n_locks):
        base = lidx * LOCK_STRIDE
        mem[base + OFF_TAIL] = base + OFF_PGRANTS
    return mem


def gen_hemlock_acquire(asm: Asm, tag: str) -> None:
    """Hemlock (Fissile Locks): one shared word per THREAD, none per lock
    beyond the tail.

    The queue is implicit: a waiter swaps into the tail and spins on its
    predecessor's single ``grant`` word (node word 0) until it holds this
    lock's signal value (lock address + 1 — distinct per lock and nonzero
    for lock 0), then clears it back to 0 (the CTR acknowledgment) so the
    predecessor's word is immediately reusable for its next acquisition.
    """
    asm.emit(SWAP, R_T1, R_LOCK, R_NODE, OFF_TAIL)   # pred = XCHG(tail, me)
    asm.emit(BEQI, R_T1, 0, 0, f"{tag}_fast")        # tail was null: lock free
    asm.emit(ADDI, R_V, R_LOCK, 0, 1)                # this lock's signal
    asm.emit(SPIN_EQ, R_V, R_T1, 0, MCS_FLAG)        # wait pred.grant == sig
    asm.emit(STOREI, R_T1, 0, 0, MCS_FLAG)           # acknowledge (clear)
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_fast")
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_in")


def gen_hemlock_release(asm: Asm, tag: str) -> None:
    asm.emit(CASZ, R_T1, R_LOCK, R_NODE, OFF_TAIL)   # tail==me ? tail = null
    asm.emit(BEQ, R_T1, R_NODE, 0, f"{tag}_done")    # no successor: done
    asm.emit(ADDI, R_V, R_LOCK, 0, 1)
    asm.emit(REL, 0, R_LIDX, 0, 0)
    asm.emit(STORE, R_NODE, R_V, 0, MCS_FLAG)        # my.grant = signal
    asm.emit(SPIN_EQI, 0, R_NODE, 0, MCS_FLAG)       # wait for the ack (== 0)
    asm.label(f"{tag}_done")


def gen_twa_sem_acquire(asm: Asm, tag: str, layout: Layout) -> None:
    """Counting semaphore augmented with the waiting array (permits K > 1).

    Ticket-based: OFF_TICKET counts draws, OFF_GRANT counts completed
    releases (FADD — releases are concurrent, unlike a mutex), and ticket
    ``tx`` may enter once ``tx - grant <= K-1``.  Exactly as in "Semaphores
    Augmented with a Waiting Array", only waiters within ``threshold`` of
    that eligibility frontier spin on the grant word (via SPIN_GE — the
    frontier moves by more than 1 per release burst, so equality spinning
    would deadlock); everyone further out parks on the hashed array slot.
    """
    K = layout.sem_permits
    thr = layout.long_term_threshold
    asm.emit(FADD, R_TX, R_LOCK, 1, OFF_TICKET)
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)
    asm.emit(SUB, R_DX, R_TX, R_G)
    asm.emit(BLEI, R_DX, 0, K - 1, f"{tag}_fast")    # a permit is free now
    asm.emit(BLEI, R_DX, 0, K - 1 + thr, f"{tag}_st")
    asm.emit(_hash_op(layout), R_AT, R_TX, R_LIDX if layout.private_arrays else R_LOCK)
    asm.label(f"{tag}_lt")
    asm.emit(LOAD, R_U, R_AT, 0, 0)
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)        # recheck grant (races)
    asm.emit(SUB, R_DX, R_TX, R_G)
    asm.emit(BLEI, R_DX, 0, K - 1 + thr, f"{tag}_st")
    asm.emit(SPIN_NE, R_U, R_AT, 0, 0)               # wait for slot to change
    if layout.count_collisions:
        _emit_wakeup_tally(asm, tag, thr, K - 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_lt")
    asm.label(f"{tag}_st")                           # short-term: spin on grant
    asm.emit(ADDI, R_T1, R_TX, 0, -(K - 1))          # enter when grant >= this
    asm.emit(SPIN_GE, R_T1, R_LOCK, 0, OFF_GRANT)
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_fast")
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_in")


def gen_twa_sem_release(asm: Asm, tag: str, layout: Layout) -> None:
    K = layout.sem_permits
    thr = layout.long_term_threshold
    asm.emit(REL, 0, R_LIDX, 0, 0)
    asm.emit(FADD, R_K, R_LOCK, 1, OFF_GRANT)        # releases++ (concurrent)
    # after this release grant' = R_K + 1; the ticket newly crossing into
    # short-term is grant' + (K-1) + thr — notify its hashed slot
    asm.emit(ADDI, R_T1, R_K, 0, K + thr)
    asm.emit(_hash_op(layout), R_AT, R_T1, R_LIDX if layout.private_arrays else R_LOCK)
    asm.emit(FADD, R_Z, R_AT, 1, 0)                  # atomic notify
    asm.emit(MOVI, R_Z, 0, 0, 0)                     # restore R_Z == 0


# --------------------------------------------------------------------------
# The TWA ticket wait/pass protocol, shared by plain ``twa`` and the
# compositions (Fissile fusion + reader-writer), which reuse it as an
# inner building block.  One copy of the protocol; flags cover the
# call-site variance instead of duplicated emit sequences.
# --------------------------------------------------------------------------

def _emit_twa_ticket_wait(asm: Asm, tag: str, layout: Layout,
                          fast_label: str | None = None,
                          tally: bool = False) -> None:
    """Draw a ticket and wait for the grant via TWA's short/long-term split.

    Falls through holding the grant (``grant == R_TX``).  If ``fast_label``
    is given, an uncontended draw (``dx == 0``) branches there instead so
    the caller can mark the acquisition unwaited.  ``tally`` inserts the
    Fig-8 collision instrumentation after each long-term wakeup.
    """
    thr = layout.long_term_threshold
    arr = R_LIDX if layout.private_arrays else R_LOCK
    asm.emit(FADD, R_TX, R_LOCK, 1, OFF_TICKET)
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)
    asm.emit(SUB, R_DX, R_TX, R_G)
    if fast_label is not None:
        asm.emit(BEQI, R_DX, 0, 0, fast_label)
    asm.emit(BLEI, R_DX, 0, thr, f"{tag}_st")
    asm.emit(_hash_op(layout), R_AT, R_TX, arr)
    asm.label(f"{tag}_lt")
    asm.emit(LOAD, R_U, R_AT, 0, 0)
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)   # recheck grant (races)
    asm.emit(SUB, R_DX, R_TX, R_G)
    asm.emit(BLEI, R_DX, 0, thr, f"{tag}_st")
    asm.emit(SPIN_NE, R_U, R_AT, 0, 0)          # wait for slot to change
    if tally:
        _emit_wakeup_tally(asm, tag, thr, 0)
    asm.emit(JMP, 0, 0, 0, f"{tag}_lt")
    asm.label(f"{tag}_st")                       # short-term: classic spin
    asm.emit(SPIN_EQ, R_TX, R_LOCK, 0, OFF_GRANT)


def _emit_twa_ticket_pass(asm: Asm, tag: str, layout: Layout,
                          rel: bool = False, restore_z: bool = True) -> None:
    """Advance the grant past ticket ``R_TX`` and notify the hashed slot of
    the waiter newly crossing into short-term.

    ``rel=True`` stamps the REL handover marker right before the grant
    store (plain ``twa``'s release); ``restore_z`` re-zeroes ``R_Z`` after
    the notify FADD clobbers it — required wherever the program still
    relies on the ``R_Z == 0`` convention downstream.
    """
    asm.emit(ADDI, R_K, R_TX, 0, 1)
    if rel:
        asm.emit(REL, 0, R_LIDX, 0, 0)
    asm.emit(STORE, R_LOCK, R_K, 0, OFF_GRANT)  # handover store FIRST
    asm.emit(ADDI, R_T1, R_K, 0, layout.long_term_threshold)
    asm.emit(_hash_op(layout), R_AT, R_T1,
             R_LIDX if layout.private_arrays else R_LOCK)
    asm.emit(FADD, R_Z, R_AT, 1, 0)             # atomic notify (collisions)
    if restore_z:
        asm.emit(MOVI, R_Z, 0, 0, 0)            # restore R_Z == 0


def gen_fissile_twa_acquire(asm: Asm, tag: str, layout: Layout) -> None:
    """Fissile fusion (Fissile Locks): a test-and-set fast path over the
    full TWA ticket + waiting-array slow path, in one program.

    The outer lock is a single TAS word (the tail sector — fissile has no
    queue, so ``OFF_TAIL`` is free).  An uncontended acquire is one SWAP.
    On failure the thread acquires the INNER TWA lock (ticket +
    ``LongTermThreshold`` split + waiting array) and, as the sole inner
    holder, camps on the TAS word — so at most ONE thread ever spins on
    the outer word (Fissile's bounded-spinning structure) while everyone
    else waits compactly in the ticket queue / waiting array.

    LOITER-style pipelining: the slow-path winner KEEPS the inner lock
    through its critical section and passes it at release, right after
    clearing the TAS — so the inner grant handover (store + notify)
    overlaps the successor's outer wake/capture chain instead of sitting
    between ACQ and the critical section.  ``R_V`` records the path taken
    (0 = fast, 1 = slow) for the release.

    Not FIFO: a fast-path arrival can barge past the inner holder — the
    uncontended-latency / long-term-fairness trade the paper describes.
    """
    asm.emit(MOVI, R_V, 0, 0, 0)                  # path flag: fast
    asm.emit(SWAP, R_T1, R_LOCK, R_T2, OFF_TAIL)  # TAS (R_T2 = tid+1, != 0)
    asm.emit(BEQI, R_T1, 0, 0, f"{tag}_fast")
    asm.emit(MOVI, R_V, 0, 0, 1)                  # path flag: slow
    _emit_twa_ticket_wait(asm, tag, layout)       # inner TWA lock (retained)
    asm.label(f"{tag}_tas")                       # sole outer-word camper
    asm.emit(SWAP, R_T1, R_LOCK, R_T2, OFF_TAIL)
    asm.emit(BEQI, R_T1, 0, 0, f"{tag}_got")
    asm.emit(SPIN_EQI, 0, R_LOCK, 0, OFF_TAIL)    # sleep till TAS == 0
    asm.emit(JMP, 0, 0, 0, f"{tag}_tas")
    asm.label(f"{tag}_got")
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_fast")
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_in")


def gen_fissile_twa_release(asm: Asm, tag: str, layout: Layout) -> None:
    asm.emit(REL, 0, R_LIDX, 0, 0)
    asm.emit(STOREI, R_LOCK, 0, 0, OFF_TAIL)      # outer TAS := 0 (handover)
    asm.emit(BEQI, R_V, 0, 0, f"{tag}_out")       # fast path never held inner
    _emit_twa_ticket_pass(asm, tag, layout)       # hand the inner lock on
    asm.label(f"{tag}_out")


def gen_twa_rw_acquire(asm: Asm, tag: str, layout: Layout) -> None:
    """TWA reader-writer lock: writers take the full TWA path, readers
    fetch-and-add a reader count.

    One TWA ticket lock arbitrates ENTRY for both roles, so long-term
    reader and writer waiting both hash into the shared waiting array.  A
    reader holds the entry lock only long enough to register
    (``OFF_RD++``), passes it on, and reads concurrently with other
    registered readers.  A writer keeps the entry lock through its whole
    critical section: it first drains the reader count to zero (at most
    one writer spins there at a time — new readers are fenced out behind
    the entry lock), writes, and passes the entry on at release.

    The per-iteration role is drawn from the thread PRNG against
    ``layout.reader_fraction`` (percent) and recorded in ``R_V`` (0 =
    reader, 1 = writer) for the release path and the rw probe.
    """
    rf = layout.reader_fraction
    asm.emit(MOVI, R_V, 0, 0, 1)                  # default: writer
    asm.emit(PRNG, R_T2, 0, 0, 100)
    asm.emit(BGTI, R_T2, 0, rf - 1, f"{tag}_entry")
    asm.emit(MOVI, R_V, 0, 0, 0)                  # reader
    asm.label(f"{tag}_entry")
    _emit_twa_ticket_wait(asm, tag, layout, fast_label=f"{tag}_fastin")
    # entry held after waiting: readers register and pass it on, writers
    # drain the reader count and keep it through the critical section
    asm.emit(BEQI, R_V, 0, 0, f"{tag}_rdw")
    asm.emit(SPIN_EQI, 0, R_LOCK, 0, OFF_RD)      # writer: drain readers
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_rdw")
    asm.emit(FADD, R_U, R_LOCK, 1, OFF_RD)        # reader: register
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_pass")
    asm.label(f"{tag}_fastin")                    # entry was uncontended
    asm.emit(BEQI, R_V, 0, 0, f"{tag}_rdf")
    asm.emit(SPIN_EQI, 0, R_LOCK, 0, OFF_RD)
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_rdf")
    asm.emit(FADD, R_U, R_LOCK, 1, OFF_RD)
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_pass")                      # reader: pass the entry on
    _emit_twa_ticket_pass(asm, tag, layout)
    asm.label(f"{tag}_in")


def gen_twa_rw_release(asm: Asm, tag: str, layout: Layout) -> None:
    asm.emit(BEQI, R_V, 0, 0, f"{tag}_rd")
    asm.emit(REL, 0, R_LIDX, 0, 0)                # writer: pass the entry
    _emit_twa_ticket_pass(asm, tag, layout)
    asm.emit(JMP, 0, 0, 0, f"{tag}_out")
    asm.label(f"{tag}_rd")
    asm.emit(REL, 0, R_LIDX, 0, 0)
    asm.emit(FADD, R_U, R_LOCK, -1, OFF_RD)       # wakes a draining writer
    asm.label(f"{tag}_out")


# --------------------------------------------------------------------------
# twa-timo: TWA with timed (abortable) acquisition.  A waiter that exhausts
# its patience budget abandons its ticket instead of waiting forever; the
# releaser skips abandoned tickets when advancing the grant.
# --------------------------------------------------------------------------

# Per-lock abandonment counters, in the ticket sector next to the ticket
# word (words 1 and 2 of the sector are otherwise unused by every lock).
TIMO_ABANDONED_OFF = OFF_TICKET + 1   # waiter-side: tickets walked away from
TIMO_SKIPPED_OFF = OFF_TICKET + 2     # releaser-side: markers consumed

# Redraw gate, one word per (thread, lock) in the thread's node flag
# sector at ``node_base + tid*MCS_NODE_STRIDE + lidx + TIMO_GATE_OFF``.
# Words 0/1 hold MCS_FLAG / the collision counters (twa-timo uses
# neither), so lock indices 0..13 fit inside the 16-word sector.
TIMO_GATE_OFF = 2

# The abandonment-arbitration ring: 32 slots recycled by ticket mod 32,
# two slots per sector so the ring fits the OFF_PGRANTS region (16
# sectors) the partitioned lock owns — a program is exactly one lock
# algorithm, so twa-timo can reuse it.  Slot ``s`` of lock ``base`` lives
# at ``base + OFF_PGRANTS + (s >> 1) * WORDS_PER_SECTOR + (s & 1)``.
TIMO_RING = 32


def _emit_timo_slot_addr(asm: Asm, ticket_reg: int, parity_reg: int) -> None:
    """R_AT <- ring-slot address for the ticket in ``ticket_reg``.

    Leaves ``s & 1`` in ``parity_reg`` (NOT R_V — ``_emit_add`` clobbers
    R_V between the two adds).  Clobbers R_T1, R_T2, R_V.
    """
    asm.emit(ANDI, R_T1, ticket_reg, 0, TIMO_RING - 1)      # s = tk & 31
    asm.emit(ANDI, parity_reg, R_T1, 0, 1)                  # s & 1
    asm.emit(SUB, R_T2, R_T1, parity_reg)                   # s - (s & 1)
    asm.emit(MULI, R_T2, R_T2, 0, WORDS_PER_SECTOR // 2)    # (s>>1)*16
    _emit_add(asm, R_AT, R_LOCK, R_T2)
    _emit_add(asm, R_AT, R_AT, parity_reg)


def gen_twa_timo_acquire(asm: Asm, tag: str, layout: Layout) -> None:
    """Timed/abortable TWA: bounded-spin acquire that may abandon its ticket.

    Waiting is POLLING, not parking — a parked thread cannot count down a
    patience budget.  Far waiters (``dx > threshold``) poll their hashed
    waiting-array slot (cheap: the slot changes at most once per handover
    epoch) and fall through to the near loop as the grant approaches; near
    waiters poll the grant word directly.  Either loop, on exhausting
    ``layout.timo_patience`` iterations, ABANDONS the ticket:

      * abandonment races the releaser through a SWAP on the ticket's ring
        slot (``TIMO_RING`` slots, ticket mod 32).  The abandoner swaps in
        the marker ``~tk``; the releaser advancing toward ``tk`` swaps in
        the offer ``tk``.  Whoever swaps second sees the other's value, so
        exactly one of {releaser skips ``tk``, waiter accepts the grant}
        happens — a timed-out-but-actually-granted waiter takes the lock
        instead of leaking a grant.
      * an abandoner may not redraw until the grant passes its dead ticket
        (the per-(thread, lock) gate word, written with SWAP for immediate
        self-visibility).  This bounds outstanding tickets by the thread
        count (<= 32), so ring slots never alias two live tickets.

    Requires ``n_threads <= TIMO_RING`` and tickets seeded away from the
    int32 wrap (the ``~tk`` marker must stay distinct from real tickets,
    which are non-negative until the wrap).
    """
    assert layout.n_threads <= TIMO_RING, "ring slots would alias"
    assert layout.n_locks <= WORDS_PER_SECTOR - TIMO_GATE_OFF, \
        "gate words overflow the node flag sector"
    thr = layout.long_term_threshold
    arr = R_LIDX if layout.private_arrays else R_LOCK
    asm.label(f"{tag}_top")
    # gate: SPIN until the grant passes any previously abandoned ticket
    # (gate word holds dead-ticket+1; 0 before the first abandonment)
    _emit_add(asm, R_AT, R_NODE, R_LIDX)
    asm.emit(LOAD, R_U, R_AT, 0, TIMO_GATE_OFF)
    asm.emit(SPIN_GE, R_U, R_LOCK, 0, OFF_GRANT)
    asm.emit(FADD, R_TX, R_LOCK, 1, OFF_TICKET)
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)
    asm.emit(SUB, R_DX, R_TX, R_G)
    asm.emit(BEQI, R_DX, 0, 0, f"{tag}_fast")
    asm.emit(MOVI, R_W, 0, 0, layout.timo_patience)      # patience budget
    asm.emit(BLEI, R_DX, 0, thr, f"{tag}_near")
    asm.emit(_hash_op(layout), R_AT, R_TX, arr)
    asm.emit(LOAD, R_U, R_AT, 0, 0)                      # slot snapshot
    asm.label(f"{tag}_far")
    asm.emit(ADDI, R_W, R_W, 0, -1)
    asm.emit(BLEI, R_W, 0, 0, f"{tag}_aband")
    asm.emit(LOAD, R_T1, R_AT, 0, 0)
    asm.emit(BEQ, R_T1, R_U, 0, f"{tag}_far")            # slot unchanged
    asm.emit(MOV, R_U, R_T1)                             # re-snapshot
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)
    asm.emit(SUB, R_DX, R_TX, R_G)
    asm.emit(BLEI, R_DX, 0, 0, f"{tag}_claim")
    asm.emit(BGTI, R_DX, 0, thr, f"{tag}_far")
    asm.label(f"{tag}_near")                             # dx within threshold
    asm.emit(LOAD, R_G, R_LOCK, 0, OFF_GRANT)
    asm.emit(SUB, R_DX, R_TX, R_G)
    asm.emit(BLEI, R_DX, 0, 0, f"{tag}_claim")
    asm.emit(ADDI, R_W, R_W, 0, -1)
    asm.emit(BGTI, R_W, 0, 0, f"{tag}_near")
    asm.label(f"{tag}_aband")                            # patience exhausted
    _emit_timo_slot_addr(asm, R_TX, R_K)
    asm.emit(SUB, R_V, R_Z, R_TX)
    asm.emit(ADDI, R_V, R_V, 0, -1)                      # marker ~tk
    asm.emit(SWAP, R_T1, R_AT, R_V, OFF_PGRANTS)
    asm.emit(BEQ, R_T1, R_TX, 0, f"{tag}_accept")        # releaser's offer
    asm.emit(ADDI, R_U, R_TX, 0, 1)                      # gate := tk + 1
    _emit_add(asm, R_AT, R_NODE, R_LIDX)
    asm.emit(SWAP, R_T1, R_AT, R_U, TIMO_GATE_OFF)       # RMW: self-visible
    asm.emit(FADD, R_U, R_LOCK, 1, TIMO_ABANDONED_OFF)
    asm.emit(JMP, 0, 0, 0, f"{tag}_top")                 # redraw (gated)
    asm.label(f"{tag}_accept")                           # granted after all
    asm.emit(SPIN_GE, R_TX, R_LOCK, 0, OFF_GRANT)
    asm.label(f"{tag}_claim")
    asm.emit(ACQ, R_LIDX, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_in")
    asm.label(f"{tag}_fast")
    asm.emit(ACQ, R_LIDX, 0, 0)
    asm.label(f"{tag}_in")


def gen_twa_timo_release(asm: Asm, tag: str, layout: Layout) -> None:
    """Advance the grant past every contiguous abandoned ticket.

    For each candidate ``g_next`` the releaser SWAPs the offer ``g_next``
    into the candidate's ring slot: seeing the marker ``~g_next`` convicts
    an abandonment (count it, skip to the next ticket); anything else
    means the candidate is live (or not yet drawn) and gets the grant.
    The skip loop terminates: outstanding markers are bounded by the
    redraw gates, and the slot for an undrawn ticket can only hold stale
    values from >= 32 tickets ago, never ``~g_next``.  Skipping past every
    marker is also what reopens the abandoners' gates.
    """
    thr = layout.long_term_threshold
    asm.emit(ADDI, R_K, R_TX, 0, 1)                      # g_next candidate
    asm.label(f"{tag}_sk")
    _emit_timo_slot_addr(asm, R_K, R_U)
    asm.emit(SWAP, R_T1, R_AT, R_K, OFF_PGRANTS)         # offer g_next
    asm.emit(SUB, R_V, R_Z, R_K)
    asm.emit(ADDI, R_V, R_V, 0, -1)                      # ~g_next
    asm.emit(BEQ, R_T1, R_V, 0, f"{tag}_skp")            # marker: abandoned
    asm.emit(REL, 0, R_LIDX, 0, 0)
    asm.emit(STORE, R_LOCK, R_K, 0, OFF_GRANT)           # handover store
    asm.emit(ADDI, R_T1, R_K, 0, thr)                    # notify new short-term
    asm.emit(_hash_op(layout), R_AT, R_T1,
             R_LIDX if layout.private_arrays else R_LOCK)
    asm.emit(FADD, R_Z, R_AT, 1, 0)
    asm.emit(MOVI, R_Z, 0, 0, 0)                         # restore R_Z == 0
    asm.emit(JMP, 0, 0, 0, f"{tag}_out")
    asm.label(f"{tag}_skp")
    asm.emit(FADD, R_U, R_LOCK, 1, TIMO_SKIPPED_OFF)
    asm.emit(ADDI, R_K, R_K, 0, 1)
    asm.emit(JMP, 0, 0, 0, f"{tag}_sk")
    asm.label(f"{tag}_out")


def anderson_init_mem(layout: Layout) -> np.ndarray:
    """Initial memory for Anderson: the slot of ticket 0 pre-granted (the
    classic ``flags[0] = 1``), per lock."""
    mem = np.zeros(layout.mem_words, np.int32)
    mask = layout.wa_size - 1
    for lidx in range(layout.n_locks):
        if layout.private_arrays:
            at = layout.wa_base + lidx * layout.wa_size  # HASHP(tx=0) -> 0
        else:
            at = layout.wa_base + (((0 * 127) ^ (lidx * LOCK_STRIDE)) & mask)
        mem[at] = 1
    return mem


# Locks whose programs need nonzero initial memory contents.
INIT_MEM_GEN = {
    "anderson": anderson_init_mem,
    "clh": clh_init_mem,
}


ACQUIRE_GEN = {
    "anderson": gen_anderson_acquire,
    "clh": lambda asm, tag, layout: gen_clh_acquire(asm, tag),
    "fissile-twa": gen_fissile_twa_acquire,
    "hemlock": lambda asm, tag, layout: gen_hemlock_acquire(asm, tag),
    "ticket": lambda asm, tag, layout: gen_ticket_acquire(asm, tag),
    "twa": gen_twa_acquire,
    "twa-rw": gen_twa_rw_acquire,
    "twa-sem": gen_twa_sem_acquire,
    "mcs": lambda asm, tag, layout: gen_mcs_acquire(asm, tag),
    "tkt-dual": lambda asm, tag, layout: gen_tkt_dual_acquire(
        asm, tag, layout.long_term_threshold),
    "twa-id": gen_twa_id_acquire,
    "twa-staged": gen_twa_staged_acquire,
    "twa-timo": gen_twa_timo_acquire,
    "partitioned": lambda asm, tag, layout: gen_partitioned_acquire(asm, tag),
}

RELEASE_GEN = {
    "anderson": gen_anderson_release,
    "clh": lambda asm, tag, layout: gen_clh_release(asm, tag),
    "fissile-twa": gen_fissile_twa_release,
    "hemlock": lambda asm, tag, layout: gen_hemlock_release(asm, tag),
    "ticket": lambda asm, tag, layout: gen_ticket_release(asm, tag),
    "twa": gen_twa_release,
    "twa-rw": gen_twa_rw_release,
    "twa-sem": gen_twa_sem_release,
    "mcs": lambda asm, tag, layout: gen_mcs_release(asm, tag),
    "tkt-dual": lambda asm, tag, layout: gen_tkt_dual_release(asm, tag),
    "twa-id": gen_twa_id_release,
    "twa-staged": lambda asm, tag, layout: gen_ticket_release(asm, tag),
    "twa-timo": gen_twa_timo_release,
    "partitioned": lambda asm, tag, layout: gen_partitioned_release(asm, tag),
}

SIM_LOCKS = sorted(ACQUIRE_GEN)


# --------------------------------------------------------------------------
# Workload programs
# --------------------------------------------------------------------------

WORK_SCALE = 8  # cycles per PRNG step (mt19937 step ≈ a few ns on the X5-2);
# calibrates CS/NCS durations relative to coherence costs so that "4 steps"
# in the paper's benchmarks means ~32 cycles, not 4.


def build_mutexbench(lock: str, layout: Layout, *, cs_work: int = 4,
                     ncs_max: int = 200, cs_rand: tuple | None = None,
                     outside_work: int = 0, collect_latency: bool = False,
                     work_scale: int = WORK_SCALE) -> np.ndarray:
    """MutexBench (paper §4.2): loop { acquire; CS; release; NCS }.

    Also covers throw (ncs_max=0, Fig 5), stress_latency (fixed work, Fig 7),
    locktorture (cs=20, ncs∈{20,400}, Figs 11/12) and the RRC profile via
    cs_rand=(lo, spread) (Fig 6).  CS/NCS are "PRNG steps" as in the paper,
    charged at `work_scale` cycles per step.

    ``outside_work`` adds a FIXED delay of that many PRNG steps between the
    release and the next acquisition attempt, *before* the random NCS draw —
    the paper's "outside work" axis: deterministic time the thread is
    guaranteed off the lock, which bounds the achievable arrival rate
    independently of the ``ncs_max`` jitter.  ``collect_latency`` brackets
    every acquisition with a TSTART mark so the engine's log2 acquire-latency
    histogram (``lat_hist``) observes ``acquire-start -> ACQ`` per
    acquisition; both default off so legacy programs are byte-identical.
    """
    if lock == "anderson" and layout.n_locks > 1 and not layout.private_arrays:
        # A cross-lock hash collision on a *boolean* flag array would grant
        # two owners at once; Anderson arrays are per-lock by definition.
        raise ValueError("anderson requires private_arrays when n_locks > 1")
    asm = Asm()
    asm.label("top")
    if layout.n_locks > 1:
        asm.emit(PRNG, R_LIDX, 0, 0, layout.n_locks)
        asm.emit(MULI, R_LOCK, R_LIDX, 0, LOCK_STRIDE)
    if collect_latency:
        asm.emit(TSTART, 0, 0, 0)
    ACQUIRE_GEN[lock](asm, "a", layout)
    if cs_rand is not None:
        lo, spread = cs_rand
        asm.emit(PRNG, R_W, 0, 0, max(spread, 1))
        asm.emit(ADDI, R_W, R_W, 0, lo)
        asm.emit(MULI, R_W, R_W, 0, work_scale)
        asm.emit(WORKR, R_W, 0, 0, 0)
    elif cs_work > 0:
        asm.emit(WORKI, 0, 0, 0, cs_work * work_scale)
    RELEASE_GEN[lock](asm, "r", layout)
    if outside_work > 0:
        asm.emit(WORKI, 0, 0, 0, outside_work * work_scale)
    if ncs_max > 0:
        asm.emit(PRNG, R_W, 0, 0, ncs_max)
        asm.emit(MULI, R_W, R_W, 0, work_scale)
        asm.emit(WORKR, R_W, 0, 0, 0)
    asm.emit(JMP, 0, 0, 0, "top")
    return asm.finish()


def init_state(layout: Layout, program_entry_pc=0) -> tuple[np.ndarray, np.ndarray]:
    """Initial pc and registers for every thread."""
    T = layout.n_threads
    pc = np.full(T, 0, np.int32)
    if np.ndim(program_entry_pc) > 0:
        pc = np.asarray(program_entry_pc, np.int32)
    else:
        pc[:] = program_entry_pc
    regs = np.zeros((T, N_REGS), np.int32)
    regs[:, R_TID] = np.arange(T)
    regs[:, R_NODE] = layout.node_base + np.arange(T) * MCS_NODE_STRIDE
    regs[:, R_LOCK] = 0         # single-lock default; multi-lock sets per-iter
    regs[:, R_LIDX] = 0
    regs[:, R_T2] = np.arange(T) + 1  # TWA-ID identity (non-zero)
    regs[:, R_Z] = 0
    return pc, regs
