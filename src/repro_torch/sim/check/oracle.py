"""Pure-NumPy sequential reference interpreter for the lockVM ISA.

One event at a time, explicit store-visibility queue, no JAX anywhere: this
is the trusted side of the differential pair.  It consumes the *same* packed
``(prog_len, 5)`` program and init arrays as ``sim.engine`` and must produce
bit-identical stats — including every cost charge, sharer-set transition and
tie-break — under :data:`repro_torch.sim.engine.EVENT_ORDER_CONTRACT`.

Implementation notes:
  * All arithmetic wraps to int32 (:func:`_w32`), matching jnp int32.
  * Sharer sets are Python ``set`` per line; the engine's packed uint32
    bitsets are semantically identical (popcount == ``len(set)``).
  * The interpreter optionally records an event trace (lock acquisitions
    with their ticket registers, stall detection) that the invariant layer
    consumes — the compiled engine cannot observe per-event ordering, the
    oracle can, which is what makes FIFO/deadlock checking possible.
  * ``mutate`` injects known bugs (see :data:`ORACLE_MUTATIONS`) for
    mutation-testing the checker itself: a checker that cannot catch an
    eagerly-visible store would also miss the real thing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import isa
from ..costs import (DEFAULT_COSTS, I_ATOMIC, I_HIT, I_INV, I_LOCAL, I_MISS,
                     I_ST_OWNED, I_ST_SHARED, I_WAKE, I_XFER, Costs)
from ..engine import EVENT_ORDER_CONTRACT, INF as _INF, N_LAT_BUCKETS
from ..faults import F_ABORT, F_PREEMPT, F_SPURIOUS, FaultSchedule

INF = int(_INF)

# Known-bug injections (mutation testing of the checker, never of the
# shipping engine): name -> description.
ORACLE_MUTATIONS = {
    "eager_store": "plain stores become globally visible at issue time "
                   "instead of at commit (breaks delayed visibility)",
    "lost_wake": "store commits update memory but never wake parked "
                 "spinners (breaks SPIN wakeup semantics)",
    "free_invalidation": "stores never pay the per-sharer C_INV bill "
                         "(breaks the invalidation-diameter cost model)",
    "dropped_fault": "the fault schedule is silently ignored (breaks "
                     "preemption/spurious-wake/abort injection semantics)",
}


@dataclass
class Trace:
    """Optional per-event observations for the invariant layer."""

    # (event_index, time, thread, lock_idx, waited, ticket_reg) per ACQ
    acquires: list = field(default_factory=list)
    # (event_index, time, thread, addr, old_value) per FADD — the liveness
    # checker reads ticket DRAWS (FADDs on a lock's OFF_TICKET word) out of
    # this; the compiled engine cannot observe when a thread joined a queue
    fadds: list = field(default_factory=list)
    # exit reason: "horizon", "max_events", "stalled" (nothing can ever
    # happen again AND at least one thread is parked on a spin — a genuine
    # lost-wakeup/deadlock state), or "halted" (every thread ran to HALT)
    exit_reason: str = ""
    # (event_index, kind, thread) per fault actually applied (a spurious
    # wake on a non-parked thread still records — the schedule fired)
    faults_applied: list = field(default_factory=list)
    # final per-thread observations the robustness invariants consume:
    # a still-parked thread's watched address (or -1) and its pc
    final_spin_addr: list = field(default_factory=list)
    final_pc: list = field(default_factory=list)
    final_regs: list = field(default_factory=list)


def _w32(x: int) -> int:
    """Wrap a Python int to int32 two's complement."""
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def _rd(idx: int) -> int:
    """Register-file GATHER index, mirroring XLA: one NumPy-style negative
    wrap, then clamp into [0, N_REGS).  The a/b/c instruction fields are
    read unconditionally (the engine reads all three before the opcode
    switch), so const-role fields outside the register range — e.g. a
    ``STOREI`` of constant 100 — must behave identically on both sides."""
    if idx < 0:
        idx += isa.N_REGS
    return 0 if idx < 0 else (isa.N_REGS - 1 if idx >= isa.N_REGS else idx)


def _wr(R: list, idx: int, val: int) -> None:
    """Register-file SCATTER, mirroring XLA ``.at[].set``: one negative
    wrap, then DROP (not clamp) when still out of range."""
    if idx < 0:
        idx += isa.N_REGS
    if 0 <= idx < isa.N_REGS:
        R[idx] = val


def run_oracle(program: np.ndarray, *, n_threads: int, mem_words: int,
               n_locks: int, init_pc: np.ndarray, init_regs: np.ndarray,
               wa_base: int, wa_size: int, horizon: int, max_events: int,
               seed: int = 1, costs: Costs | np.ndarray = DEFAULT_COSTS,
               init_mem: np.ndarray | None = None,
               n_active: int | None = None, trace: Trace | None = None,
               mutate: tuple = (), faults=None) -> dict:
    """Interpret one cell sequentially; returns engine-identical raw stats.

    The returned dict carries exactly the fields ``engine.run_sweep`` emits
    per cell (``acquisitions``, ``waited_acquisitions``, ``handover_sum``,
    ``handover_count``, ``events``, ``sleeping``, ``grant_value``,
    ``lat_hist``) so the
    differential runner can compare them verbatim.  ``faults`` is an
    optional :class:`repro_torch.sim.faults.FaultSchedule` (or its ``to_lists``
    row form) applied under the extended fault clause of
    :data:`EVENT_ORDER_CONTRACT`.
    """
    assert wa_size & (wa_size - 1) == 0
    for m in mutate:
        assert m in ORACLE_MUTATIONS, m
    eager_store = "eager_store" in mutate
    lost_wake = "lost_wake" in mutate
    free_inv = "free_invalidation" in mutate
    dropped_fault = "dropped_fault" in mutate

    if faults is not None and not isinstance(faults, FaultSchedule):
        faults = FaultSchedule.from_lists(faults)
    fault_by_evt: dict[int, tuple[int, int, int]] = {}
    if faults is not None and not dropped_fault:
        for fk, fe, ft, fa in zip(faults.kind, faults.evt,
                                  faults.tid, faults.arg):
            if int(fk) != 0:
                assert int(fe) not in fault_by_evt, "duplicate fault evt"
                fault_by_evt[int(fe)] = (int(fk), int(ft), int(fa))

    if isinstance(costs, Costs):
        costs = costs.to_array()
    C = [int(v) for v in np.asarray(costs, np.int64)]
    prog = [tuple(int(v) for v in row) for row in np.asarray(program)]
    wa_mask = wa_size - 1
    if n_active is None:
        n_active = n_threads

    T = n_threads
    next_time = [0 if t < n_active else INF for t in range(T)]
    pc = [int(v) for v in np.asarray(init_pc)]
    regs = [[int(v) for v in row] for row in np.asarray(init_regs)]
    prng = [(seed + t * 2654435761) & 0xFFFFFFFF for t in range(T)]
    if init_mem is None:
        mem = [0] * mem_words
    else:
        mem = [int(v) for v in np.asarray(init_mem)]
    n_lines = mem_words // isa.WORDS_PER_SECTOR
    sharers: list[set] = [set() for _ in range(n_lines)]
    dirty = [-1] * n_lines
    pend_addr = [-1] * T
    pend_val = [0] * T
    pend_time = [0] * T
    spin_addr = [-1] * T
    wake_delay = [0] * T
    acq = [0] * T
    waited_acq = [0] * T
    rel_time = [-1] * n_locks
    hand_sum = 0
    hand_cnt = 0
    events = 0
    acq_t0 = [-1] * T
    lat_hist = [0] * N_LAT_BUCKETS

    def load_cost(t, ln):
        mine = t in sharers[ln]
        if mine:
            return C[I_HIT]
        d = dirty[ln]
        return C[I_XFER] if (d >= 0 and d != t) else C[I_MISS]

    def store_cost(t, ln, atomic):
        row = sharers[ln]
        others = len(row) - (1 if t in row else 0)
        if t in row and others == 0:
            cost = C[I_ST_OWNED]
        else:
            cost = C[I_ST_SHARED] + (0 if free_inv else C[I_INV] * others)
        return cost + (C[I_ATOMIC] if atomic else 0)

    def wake_watchers(addr, wake_time):
        for u in range(T):
            if spin_addr[u] == addr:
                # a woken thread pays any preemption debt accrued while
                # parked (wake_delay) on top of C_WAKE, then the debt clears
                next_time[u] = _w32(wake_time + C[I_WAKE] + wake_delay[u])
                wake_delay[u] = 0
                spin_addr[u] = -1

    def select():
        """Event selection (EVENT_ORDER_CONTRACT): earliest commit wins a
        tie against the earliest thread op; lowest index wins within a
        half."""
        t_cm, tc = INF, 0
        for u in range(T):
            if pend_addr[u] >= 0 and pend_time[u] < t_cm:
                t_cm, tc = pend_time[u], u
        t_th, tt = INF, 0
        for u in range(T):
            if next_time[u] < t_th:
                t_th, tt = next_time[u], u
        return t_cm, tc, t_th, tt

    while True:
        t_cm, tc, t_th, tt = select()
        now = min(t_cm, t_th)
        if not (events < max_events and now < horizon):
            if trace is not None:
                if events >= max_events:
                    trace.exit_reason = "max_events"
                elif now < INF:
                    trace.exit_reason = "horizon"
                elif any(s >= 0 for s in spin_addr):
                    trace.exit_reason = "stalled"
                else:
                    trace.exit_reason = "halted"
                trace.final_spin_addr = list(spin_addr)
                trace.final_pc = list(pc)
                trace.final_regs = [list(r) for r in regs]
            break

        # --- fault phase (extended EVENT_ORDER_CONTRACT) ------------------
        # An entry matching the current event counter mutates the timelines
        # as a persisted state change, then the event re-selects; if the
        # fault pushed every timeline past the horizon, no event executes
        # and the counter does not advance (the loop exits on re-check).
        fe = fault_by_evt.get(events)
        if fe is not None:
            kind, ftid, farg = fe
            if trace is not None:
                trace.faults_applied.append((events, kind, ftid))
            if kind == F_PREEMPT:
                if next_time[ftid] < INF:
                    next_time[ftid] = _w32(next_time[ftid] + farg)
                else:
                    # parked/halted: the debt is paid at the next wake
                    wake_delay[ftid] = _w32(wake_delay[ftid] + farg)
            elif kind == F_SPURIOUS:
                if spin_addr[ftid] >= 0:
                    # resume with pc still on the SPIN op: re-pay the load,
                    # re-check, re-park if the condition still fails
                    next_time[ftid] = _w32(now + C[I_WAKE] + wake_delay[ftid])
                    wake_delay[ftid] = 0
                    spin_addr[ftid] = -1
            else:
                assert kind == F_ABORT, kind
                next_time[ftid] = INF
                spin_addr[ftid] = -1  # dead, not parked: never wakeable
            t_cm, tc, t_th, tt = select()
            now = min(t_cm, t_th)
            if now >= horizon:
                continue

        events += 1
        is_commit = t_cm <= t_th  # tie resolves to the commit

        if is_commit:
            # pseudo-op: the earliest pending store becomes globally visible
            t = tc
            addr = pend_addr[t]
            ln = addr >> isa.LINE_SHIFT
            mem[addr] = pend_val[t]
            sharers[ln] = {t}
            dirty[ln] = t
            pend_addr[t] = -1
            if not lost_wake:
                wake_watchers(addr, now)
            continue

        t = tt
        op, a, b, c_, imm = prog[pc[t]]
        R = regs[t]
        ra, rb, rc = R[_rd(a)], R[_rd(b)], R[_rd(c_)]
        new_pc = pc[t] + 1
        cost = C[I_LOCAL]
        sleep = False

        if op == isa.NOP:
            pass
        elif op == isa.LOAD:
            addr = _w32(rb + imm)
            ln = addr >> isa.LINE_SHIFT
            cost = load_cost(t, ln)
            if t not in sharers[ln] and dirty[ln] >= 0 and dirty[ln] != t:
                dirty[ln] = -1  # foreign dirty line downgraded by the read
            _wr(R, a, mem[addr])
            sharers[ln].add(t)
        elif op in (isa.STORE, isa.STOREI):
            addr = _w32(ra + imm)
            val = rb if op == isa.STORE else b
            ln = addr >> isa.LINE_SHIFT
            cost = store_cost(t, ln, False)
            pend_addr[t] = addr
            pend_val[t] = val
            pend_time[t] = _w32(now + cost)
            if eager_store:
                mem[addr] = val  # BUG: visible before the commit event
        elif op in (isa.FADD, isa.SWAP, isa.CASZ):
            addr = _w32(rb + imm)
            ln = addr >> isa.LINE_SHIFT
            cost = store_cost(t, ln, True)
            old = mem[addr]
            if op == isa.FADD:
                new = _w32(old + c_)
            elif op == isa.SWAP:
                new = rc
            else:  # CASZ
                new = 0 if old == rc else old
            _wr(R, a, old)
            mem[addr] = new
            sharers[ln] = {t}
            dirty[ln] = t
            wake_watchers(addr, _w32(now + cost))
            if trace is not None and op == isa.FADD:
                trace.fadds.append((events, now, t, addr, old))
        elif op == isa.ADDI:
            _wr(R, a, _w32(rb + imm))
        elif op == isa.MOVI:
            _wr(R, a, imm)
        elif op == isa.MOV:
            _wr(R, a, rb)
        elif op == isa.SUB:
            _wr(R, a, _w32(rb - rc))
        elif op == isa.MULI:
            _wr(R, a, _w32(rb * imm))
        elif op == isa.ANDI:
            _wr(R, a, rb & imm)
        elif op == isa.HASH:
            _wr(R, a, _w32(wa_base + ((_w32(rb * 127) ^ rc) & wa_mask)))
        elif op == isa.HASHP:
            _wr(R, a, _w32(wa_base + rc * wa_size + (_w32(rb * 127) & wa_mask)))
        elif op in (isa.BEQ, isa.BNE, isa.BLE, isa.BGT,
                    isa.BEQI, isa.BNEI, isa.BLEI, isa.BGTI, isa.JMP):
            taken = {isa.BEQ: ra == rb, isa.BNE: ra != rb,
                     isa.BLE: ra <= rb, isa.BGT: ra > rb,
                     isa.BEQI: ra == c_, isa.BNEI: ra != c_,
                     isa.BLEI: ra <= c_, isa.BGTI: ra > c_,
                     isa.JMP: True}[op]
            if taken:
                new_pc = imm
        elif op == isa.WORKI:
            cost = max(imm, 1)
        elif op == isa.WORKR:
            cost = max(ra, 1)
        elif op == isa.PRNG:
            sd = (prng[t] * 1664525 + 1013904223) & 0xFFFFFFFF
            _wr(R, a, (sd >> 16) % max(imm, 1))
            prng[t] = sd
        elif op in (isa.SPIN_EQ, isa.SPIN_NE, isa.SPIN_EQI, isa.SPIN_NEI,
                    isa.SPIN_GE):
            addr = _w32(rb + imm)
            ln = addr >> isa.LINE_SHIFT
            cost = load_cost(t, ln)
            val = mem[addr]
            proceed = {isa.SPIN_EQ: val == ra, isa.SPIN_NE: val != ra,
                       isa.SPIN_EQI: val == c_, isa.SPIN_NEI: val != c_,
                       # wrap-safe frontier compare (sign of the int32
                       # difference), mirroring engine.h_spin_ge
                       isa.SPIN_GE: _w32(val - ra) >= 0}[op]
            sharers[ln].add(t)
            if not proceed:
                new_pc = pc[t]
                sleep = True
                spin_addr[t] = addr
        elif op == isa.ACQ:
            lidx = ra
            rt = rel_time[lidx]
            waited = c_ > 0
            got = waited and rt >= 0
            acq[t] += 1
            if waited:
                waited_acq[t] += 1
            if got:
                hand_sum = _w32(hand_sum + now - rt)
                hand_cnt += 1
                rel_time[lidx] = -1
            # consume a pending TSTART mark into the log2 latency histogram
            # (same bucket formula as engine.h_acq, bit for bit)
            if acq_t0[t] >= 0:
                blat = max(_w32(now - acq_t0[t]), 0)
                bucket = sum(blat >= (1 << k)
                             for k in range(N_LAT_BUCKETS - 1))
                lat_hist[bucket] += 1
                acq_t0[t] = -1
            if trace is not None:
                trace.acquires.append(
                    (events, now, t, lidx, waited, R[isa.R_TX]))
        elif op == isa.TSTART:
            acq_t0[t] = now
        elif op == isa.REL:
            rel_time[rb] = now
        elif op == isa.HALT:
            cost = INF
            new_pc = pc[t]
        else:  # pragma: no cover - OPCODES is exhaustive
            raise AssertionError(f"unknown opcode {op}")

        pc[t] = new_pc
        next_time[t] = INF if sleep else _w32(now + cost)

    return {
        "acquisitions": np.asarray(acq, np.int32),
        "waited_acquisitions": np.asarray(waited_acq, np.int32),
        "handover_sum": np.int32(hand_sum),
        "handover_count": np.int32(hand_cnt),
        "events": np.int32(events),
        "sleeping": np.int32(sum(1 for s in spin_addr if s >= 0)),
        "grant_value": np.asarray(mem, np.int32),
        "lat_hist": np.asarray(lat_hist, np.int32),
    }


# Re-exported so checker code (and its docs) can cite the shared contract
# without importing the JAX engine.
__all__ = ["run_oracle", "Trace", "ORACLE_MUTATIONS", "EVENT_ORDER_CONTRACT"]
