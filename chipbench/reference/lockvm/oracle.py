"""Pure-NumPy sequential reference interpreter for the lockVM ISA.

A frozen copy of ``repro_torch.sim.check.oracle``, trimmed to what the
benchmark's cells reach (no fault schedule, no event trace), kept beside
the benchmark as its yardstick: the program may change, this may not.

One event at a time, explicit store-visibility queue: it consumes the same
program and initial arrays as the program's engine and must produce
bit-identical stats, including every cost charge, sharer-set transition
and tie-break.  All arithmetic wraps to int32 (:func:`_w32`); sharer sets
are Python ``set`` per line (the engine's packed bitsets are semantically
identical).  ``mutate`` breaks the cost model on purpose: the benchmark's
control (see :data:`ORACLE_MUTATIONS`).
"""

from __future__ import annotations

import numpy as np

from . import isa
from .costs import (DEFAULT_COSTS, I_ATOMIC, I_HIT, I_INV, I_LOCAL, I_MISS,
                     I_ST_OWNED, I_ST_SHARED, I_WAKE, I_XFER, Costs)

INF = 1 << 29          # the engines' "never" time
N_LAT_BUCKETS = 32     # log2 buckets of the acquire-latency histogram

# Known-bug injections: name -> description.
ORACLE_MUTATIONS = {
    "free_invalidation": "stores never pay the per-sharer C_INV bill "
                         "(breaks the invalidation-diameter cost model)",
}


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
               mutate: tuple = ()) -> dict:
    """Interpret one cell sequentially; returns engine-identical raw stats:
    exactly the fields the engine's ``run_sweep`` emits per cell
    (``acquisitions``, ``waited_acquisitions``, ``handover_sum``,
    ``handover_count``, ``events``, ``sleeping``, ``grant_value``,
    ``lat_hist``)."""
    assert wa_size & (wa_size - 1) == 0
    for m in mutate:
        assert m in ORACLE_MUTATIONS, m
    free_inv = "free_invalidation" in mutate

    if isinstance(costs, Costs):
        costs = costs.to_array()
    C = [int(v) for v in np.asarray(costs, np.int64)]
    prog = [tuple(int(v) for v in row) for row in np.asarray(program)]
    wa_mask = wa_size - 1
    T = n_threads
    next_time = [0] * T
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
                next_time[u] = _w32(wake_time + C[I_WAKE])
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
            break

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
        elif op == isa.TSTART:
            acq_t0[t] = now
        elif op == isa.REL:
            rel_time[rb] = now
        elif op == isa.HALT:
            cost = INF
            new_pc = pc[t]
        else:  # pragma: no cover - every opcode is handled above
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

