"""Vectorized NumPy lockstep oracle: many scenarios stepped at once.

Each iteration of the main loop advances every still-active case by exactly
ONE event (a store commit or a thread op), mirroring
:func:`repro_torch.sim.check.oracle.run_oracle` under the same
``EVENT_ORDER_CONTRACT`` — per-case ``argmin`` event selection, the commit
tie-break, delayed store visibility, SPIN wakeups, the MESI-style cost
model, int32 wrap arithmetic.  State lives in ``(B, ...)`` arrays with a
per-case active mask; cases that hit their horizon/event budget drop out of
the subset indexing and stop costing anything.

This interpreter is deliberately independent of the engine's code path
(plain NumPy, no JAX) AND of the sequential oracle's code path: the
sequential oracle stays the reference that this batch oracle is itself
differentially tested against (``tests/test_check_batch_oracle.py`` pins
bit-identity of every stat and trace over the corpus and fresh batches).

Two escape hatches keep the semantics exactly honest rather than "close":

  * **Sequential fallback** — a case whose program computes an
    out-of-range memory address, lock index, pc, or opcode (possible only
    for adversarial/hand-built inputs; the generators can't produce them)
    is deferred and re-run through ``run_oracle``, which reproduces the
    reference behaviour *including the exception it would raise*.  In-range
    negative indices are NOT deferred: NumPy's fancy indexing wraps them
    exactly like the oracle's Python lists.
  * **Raw addresses** — ``pend_addr``/``spin_addr`` store the raw
    ``_w32`` address (not a normalized one), because the sequential oracle
    compares raw values for commit-presence (``>= 0``) and wakeup matching.

``mutate`` supports the same checker self-test injections as the sequential
oracle (:data:`repro_torch.sim.check.oracle.ORACLE_MUTATIONS`), so mutation
self-tests run through the batch path too.

With ``collect_coverage=True`` the interpreter also accumulates the cheap
per-case counters :mod:`repro_torch.sim.check.coverage` turns into signatures:
opcode execution, taken branches, failed-spin parks, store commits,
wakeups, and RMW sign-flip (wrap) events.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import isa
from ..costs import (I_ATOMIC, I_HIT, I_INV, I_LOCAL, I_MISS, I_ST_OWNED,
                     I_ST_SHARED, I_WAKE, I_XFER)
from ..engine import N_LAT_BUCKETS
from ..faults import F_ABORT, F_PREEMPT, F_SPURIOUS
from .generate import scenario_faults
from .oracle import INF, ORACLE_MUTATIONS, Trace, run_oracle
from . import _fastcase

_EXIT_NAMES = {1: "max_events", 2: "horizon", 3: "stalled", 4: "halted"}

# Coverage axes (see coverage.py): taken-branch kinds BEQ..JMP, spin kinds
# SPIN_EQ..SPIN_NEI plus SPIN_GE.
N_BRANCH_KINDS = isa.JMP - isa.BEQ + 1
N_SPIN_KINDS = 5


def _w32(x: np.ndarray) -> np.ndarray:
    """Elementwise int32 two's-complement wrap, kept in int64."""
    return x.astype(np.int32).astype(np.int64)


def _rd(idx: np.ndarray) -> np.ndarray:
    """Vectorized register GATHER index: one negative wrap, then clamp."""
    idx = np.where(idx < 0, idx + isa.N_REGS, idx)
    return np.clip(idx, 0, isa.N_REGS - 1)


@dataclass
class BatchOracleResult:
    """Per-case outputs of :func:`run_batch_oracle`.

    ``stats[i]``/``traces[i]`` are bit-identical to what
    ``run_oracle(..., trace=Trace())`` returns for ``scenarios[i]``.
    ``coverage`` (when requested) maps counter names to ``(B, ...)`` arrays;
    rows of deferred cases are zeroed.  ``fallbacks[i]`` marks cases that
    were re-run on the sequential oracle.
    """

    stats: list
    traces: list | None
    coverage: dict | None
    fallbacks: np.ndarray


def run_batch_oracle(scenarios, mutate: tuple = (),
                     collect_trace: bool = True,
                     collect_coverage: bool = False,
                     impl: str = "auto") -> BatchOracleResult:
    """Interpret a padded scenario batch in lockstep; engine-identical stats.

    All scenarios must share ``(n_threads, mem_words, n_locks)`` and program
    length — the same padded batch-shared shapes ``generate.py`` produces
    and ``run_engine_batch`` asserts.

    ``impl`` picks the interpreter: ``"numpy"`` is the lockstep NumPy path
    this module implements, ``"c"`` the compiled per-case kernel from
    :mod:`._fastcase` (both bit-identical to the sequential reference;
    the C path carries the fuzz-scale throughput target), and ``"auto"``
    (the default) the C path whenever a compiler was available.
    """
    for m in mutate:
        assert m in ORACLE_MUTATIONS, m
    eager_store = "eager_store" in mutate
    lost_wake = "lost_wake" in mutate
    free_inv = "free_invalidation" in mutate
    dropped_fault = "dropped_fault" in mutate

    B = len(scenarios)
    if not B:
        return BatchOracleResult([], [] if collect_trace else None,
                                 None, np.zeros(0, bool))
    s0 = scenarios[0]
    T, M, L = s0.n_threads, s0.mem_words, s0.n_locks
    for s in scenarios:
        assert (s.n_threads, s.mem_words, s.n_locks) == (T, M, L), \
            "batch not padded"
        assert s.wa_size & (s.wa_size - 1) == 0
    if impl == "auto":
        impl = "c" if _fastcase.HAVE_FAST else "numpy"
    if impl == "c":
        if not _fastcase.HAVE_FAST:
            raise RuntimeError("impl='c' requested but no C compiler found")
        return _run_batch_c(scenarios, mutate, collect_trace,
                            collect_coverage)
    assert impl == "numpy", impl
    n_lines = M // isa.WORDS_PER_SECTOR

    prog = np.stack([np.asarray(s.program) for s in scenarios]).astype(
        np.int64)
    P = prog.shape[1]
    C = np.stack([np.asarray(s.costs) for s in scenarios]).astype(np.int64)
    horizon = np.asarray([s.horizon for s in scenarios], np.int64)
    max_events = np.asarray([s.max_events for s in scenarios], np.int64)
    wa_base = np.asarray([s.wa_base for s in scenarios], np.int64)
    wa_size = np.asarray([s.wa_size for s in scenarios], np.int64)
    wa_mask = wa_size - 1
    n_active = np.asarray([T if s.n_active is None else s.n_active
                           for s in scenarios], np.int64)
    seeds = np.asarray([s.seed for s in scenarios], np.int64)

    # Per-case fault schedules (meta["faults"]), padded to a shared width.
    # ``dropped_fault`` is the checker-self-test mutation: the schedules are
    # silently ignored, which the differential layer must catch.
    scheds = [scenario_faults(s) for s in scenarios]
    n_faults = max((len(sc) for sc in scheds if sc is not None), default=0)
    have_faults = n_faults > 0 and not dropped_fault
    if have_faults:
        f_kind = np.zeros((B, n_faults), np.int64)
        f_evt = np.zeros((B, n_faults), np.int64)
        f_tid = np.zeros((B, n_faults), np.int64)
        f_arg = np.zeros((B, n_faults), np.int64)
        for i, sc in enumerate(scheds):
            if sc is not None and len(sc):
                k, e, t, g = sc.padded(n_faults)
                f_kind[i], f_evt[i], f_tid[i], f_arg[i] = k, e, t, g

    tids = np.arange(T, dtype=np.int64)
    next_time = np.where(tids[None, :] < n_active[:, None], 0,
                         INF).astype(np.int64)
    pc = np.stack([np.asarray(s.init_pc) for s in scenarios]).astype(np.int64)
    regs = np.stack([np.asarray(s.init_regs)
                     for s in scenarios]).astype(np.int64)
    prng = (seeds[:, None] + tids[None, :] * 2654435761) & 0xFFFFFFFF
    mem = np.stack([np.asarray(s.init_mem) for s in scenarios]).astype(
        np.int64)
    sharers = np.zeros((B, n_lines, T), bool)
    dirty = np.full((B, n_lines), -1, np.int64)
    pend_addr = np.full((B, T), -1, np.int64)
    pend_val = np.zeros((B, T), np.int64)
    pend_time = np.zeros((B, T), np.int64)
    spin_addr = np.full((B, T), -1, np.int64)
    wake_delay = np.zeros((B, T), np.int64)
    acq = np.zeros((B, T), np.int64)
    waited_acq = np.zeros((B, T), np.int64)
    rel_time = np.full((B, L), -1, np.int64)
    hand_sum = np.zeros(B, np.int64)
    hand_cnt = np.zeros(B, np.int64)
    events = np.zeros(B, np.int64)
    acq_t0 = np.full((B, T), -1, np.int64)
    lat_hist = np.zeros((B, N_LAT_BUCKETS), np.int64)
    active = np.ones(B, bool)
    fallback = np.zeros(B, bool)
    exit_code = np.zeros(B, np.int64)

    if collect_coverage:
        op_exec = np.zeros((B, isa.N_OPS), np.int64)
        branch_taken = np.zeros((B, N_BRANCH_KINDS), np.int64)
        spin_sleep = np.zeros((B, N_SPIN_KINDS), np.int64)
        commits_cov = np.zeros(B, np.int64)
        wakes_cov = np.zeros(B, np.int64)
        wraps_cov = np.zeros(B, np.int64)
    acq_buf: list = []
    fadd_buf: list = []

    def _defer(cases):
        fallback[cases] = True
        active[cases] = False

    while True:
        run = np.flatnonzero(active)
        if run.size == 0:
            break
        # --- event selection (EVENT_ORDER_CONTRACT), per case -------------
        cm = np.where(pend_addr[run] >= 0, pend_time[run], INF)
        nt = next_time[run]
        ar = np.arange(run.size)
        tc = cm.argmin(1)            # argmin == first minimum == lowest tid
        t_cm = cm[ar, tc]
        tt = nt.argmin(1)
        t_th = nt[ar, tt]
        now = np.minimum(t_cm, t_th)
        ev = events[run]
        stop = (ev >= max_events[run]) | (now >= horizon[run])
        if stop.any():
            sidx = run[stop]
            me = ev[stop] >= max_events[sidx]
            hz = ~me & (now[stop] < INF)
            st = ~me & ~hz & (spin_addr[sidx] >= 0).any(1)
            exit_code[sidx] = np.where(me, 1, np.where(hz, 2,
                                                       np.where(st, 3, 4)))
            active[sidx] = False
            if stop.all():
                continue
            keep = ~stop
            run, tc, t_cm, tt, t_th, now = (run[keep], tc[keep], t_cm[keep],
                                            tt[keep], t_th[keep], now[keep])
        # --- fault phase (extended EVENT_ORDER_CONTRACT): entries whose
        # event index equals the case's event counter mutate persisted
        # state BEFORE event selection; the event is then re-selected from
        # the post-fault state, and a case pushed past its horizon executes
        # no event this iteration (its event counter does not advance).
        if have_faults:
            fm = (f_kind[run] != 0) & (f_evt[run] == events[run][:, None])
            fhit = fm.any(1)
            if fhit.any():
                hi = np.flatnonzero(fhit)
                slot = fm[hi].argmax(1)  # unique evts: at most one match
                cases = run[hi]
                kind = f_kind[cases, slot]
                ftid = f_tid[cases, slot]
                farg = f_arg[cases, slot]
                fnow = now[hi]
                pre = kind == F_PREEMPT
                if pre.any():
                    cp, tp, ap = cases[pre], ftid[pre], farg[pre]
                    on = next_time[cp, tp] < INF
                    next_time[cp[on], tp[on]] = _w32(
                        next_time[cp[on], tp[on]] + ap[on])
                    off = ~on
                    wake_delay[cp[off], tp[off]] = _w32(
                        wake_delay[cp[off], tp[off]] + ap[off])
                spw = kind == F_SPURIOUS
                if spw.any():
                    cs, ts = cases[spw], ftid[spw]
                    parked = spin_addr[cs, ts] >= 0
                    cs, ts = cs[parked], ts[parked]
                    fn = fnow[spw][parked]
                    next_time[cs, ts] = _w32(fn + C[cs, I_WAKE]
                                             + wake_delay[cs, ts])
                    wake_delay[cs, ts] = 0
                    spin_addr[cs, ts] = -1
                ab = kind == F_ABORT
                if ab.any():
                    ca, ta = cases[ab], ftid[ab]
                    next_time[ca, ta] = INF
                    spin_addr[ca, ta] = -1
                cm2 = np.where(pend_addr[cases] >= 0, pend_time[cases], INF)
                ar2 = np.arange(cases.size)
                tc2 = cm2.argmin(1)
                nt2 = next_time[cases]
                tt2 = nt2.argmin(1)
                tc[hi], t_cm[hi] = tc2, cm2[ar2, tc2]
                tt[hi], t_th[hi] = tt2, nt2[ar2, tt2]
                now[hi] = np.minimum(t_cm[hi], t_th[hi])
                over = now >= horizon[run]
                if over.any():
                    keep = ~over
                    run, tc, t_cm, tt, t_th, now = (
                        run[keep], tc[keep], t_cm[keep], tt[keep],
                        t_th[keep], now[keep])
                    if run.size == 0:
                        continue
        events[run] += 1
        is_cm = t_cm <= t_th  # tie resolves to the commit

        # --- commit half: earliest pending store becomes visible ----------
        if is_cm.any():
            cg = run[is_cm]
            th = tc[is_cm]
            cnow = now[is_cm]
            addr = pend_addr[cg, th]   # >= 0 and < M by construction
            ln = addr >> isa.LINE_SHIFT
            mem[cg, addr] = pend_val[cg, th]
            sharers[cg, ln] = False
            sharers[cg, ln, th] = True
            dirty[cg, ln] = th
            pend_addr[cg, th] = -1
            if collect_coverage:
                commits_cov[cg] += 1
            if not lost_wake:
                resume = _w32(cnow + C[cg, I_WAKE])
                sa = spin_addr[cg]
                watch = sa == addr[:, None]
                if watch.any():
                    ntc = next_time[cg]
                    ntc[watch] = _w32(np.broadcast_to(
                        resume[:, None], watch.shape) + wake_delay[cg])[watch]
                    next_time[cg] = ntc
                    wd = wake_delay[cg]
                    wd[watch] = 0
                    wake_delay[cg] = wd
                    sa[watch] = -1
                    spin_addr[cg] = sa
                    if collect_coverage:
                        wakes_cov[cg] += watch.sum(1)

        # --- thread half: one instruction per remaining case --------------
        tg0 = run[~is_cm]
        if tg0.size == 0:
            continue
        th0 = tt[~is_cm]
        tnow0 = now[~is_cm]
        tpc0 = pc[tg0, th0]
        badp = (tpc0 < -P) | (tpc0 >= P)
        if badp.any():
            _defer(tg0[badp])
            good = ~badp
            tg0, th0, tnow0, tpc0 = (tg0[good], th0[good], tnow0[good],
                                     tpc0[good])
            if tg0.size == 0:
                continue
        ins = prog[tg0, tpc0]
        op = ins[:, 0]
        a, b, c_, imm = ins[:, 1], ins[:, 2], ins[:, 3], ins[:, 4]
        ra = regs[tg0, th0, _rd(a)]
        rb = regs[tg0, th0, _rd(b)]
        rc = regs[tg0, th0, _rd(c_)]
        new_pc = tpc0 + 1
        cost = C[tg0, I_LOCAL].copy()
        sleep = np.zeros(tg0.size, bool)
        dead = np.zeros(tg0.size, bool)
        if collect_coverage:
            okop = (op >= 0) & (op < isa.N_OPS)
            np.add.at(op_exec, (tg0[okop], op[okop]), 1)

        def memaddr(sub, base):
            """w32 effective address; defer cases outside [-M, M)."""
            addr = _w32(base + imm[sub])
            bad = (addr < -M) | (addr >= M)
            if bad.any():
                _defer(tg0[sub[bad]])
                dead[sub[bad]] = True
                sub, addr = sub[~bad], addr[~bad]
            return sub, addr

        def wr(sub, idx, val):
            """Vectorized register SCATTER: wrap once, DROP when still OOB."""
            idx = np.where(idx < 0, idx + isa.N_REGS, idx)
            ok = (idx >= 0) & (idx < isa.N_REGS)
            if not ok.all():
                sub, idx, val = sub[ok], idx[ok], val[ok]
            regs[tg0[sub], th0[sub], idx] = val

        def load_cost(cases, th, ln):
            mine = sharers[cases, ln, th]
            d = dirty[cases, ln]
            lc = np.where(mine, C[cases, I_HIT],
                          np.where((d >= 0) & (d != th),
                                   C[cases, I_XFER], C[cases, I_MISS]))
            return lc, mine, d

        def store_cost(cases, th, ln, atomic):
            row = sharers[cases, ln]
            mine = row[np.arange(cases.size), th]
            others = row.sum(1) - mine
            sc = np.where(mine & (others == 0), C[cases, I_ST_OWNED],
                          C[cases, I_ST_SHARED]
                          + (0 if free_inv else C[cases, I_INV] * others))
            return sc + C[cases, I_ATOMIC] if atomic else sc

        def wake(cases, addr, resume):
            sa = spin_addr[cases]
            watch = sa == addr[:, None]
            if watch.any():
                ntc = next_time[cases]
                ntc[watch] = _w32(np.broadcast_to(
                    resume[:, None], watch.shape) + wake_delay[cases])[watch]
                next_time[cases] = ntc
                wd = wake_delay[cases]
                wd[watch] = 0
                wake_delay[cases] = wd
                sa[watch] = -1
                spin_addr[cases] = sa
                if collect_coverage:
                    wakes_cov[cases] += watch.sum(1)

        # LOAD
        s = np.flatnonzero(op == isa.LOAD)
        if s.size:
            s, addr = memaddr(s, rb[s])
        if s.size:
            cases, th = tg0[s], th0[s]
            ln = addr >> isa.LINE_SHIFT
            lc, mine, d = load_cost(cases, th, ln)
            cost[s] = lc
            downg = ~mine & (d >= 0) & (d != th)
            if downg.any():
                dirty[cases[downg], ln[downg]] = -1
            wr(s, a[s], mem[cases, addr])
            sharers[cases, ln, th] = True

        # STORE / STOREI — issue only; visibility happens at the commit
        s = np.flatnonzero((op == isa.STORE) | (op == isa.STOREI))
        if s.size:
            s, addr = memaddr(s, ra[s])
        if s.size:
            cases, th = tg0[s], th0[s]
            ln = addr >> isa.LINE_SHIFT
            cost[s] = store_cost(cases, th, ln, False)
            val = np.where(op[s] == isa.STORE, rb[s], b[s])
            pend_addr[cases, th] = addr
            pend_val[cases, th] = val
            pend_time[cases, th] = _w32(tnow0[s] + cost[s])
            if eager_store:
                mem[cases, addr] = val  # BUG: visible before the commit

        # FADD / SWAP / CASZ
        s = np.flatnonzero((op >= isa.FADD) & (op <= isa.CASZ))
        if s.size:
            s, addr = memaddr(s, rb[s])
        if s.size:
            cases, th = tg0[s], th0[s]
            ln = addr >> isa.LINE_SHIFT
            cost[s] = store_cost(cases, th, ln, True)
            old = mem[cases, addr]
            new = np.where(op[s] == isa.FADD, _w32(old + c_[s]),
                           np.where(op[s] == isa.SWAP, rc[s],
                                    np.where(old == rc[s], 0, old)))
            wr(s, a[s], old)
            mem[cases, addr] = new
            sharers[cases, ln] = False
            sharers[cases, ln, th] = True
            dirty[cases, ln] = th
            wake(cases, addr, _w32(_w32(tnow0[s] + cost[s])
                                   + C[cases, I_WAKE]))
            if collect_coverage:
                flip = (old < 0) != (new < 0)
                if flip.any():
                    wraps_cov[cases[flip]] += 1
            fa = op[s] == isa.FADD
            if collect_trace and fa.any():
                fadd_buf.append((cases[fa], events[cases[fa]],
                                 tnow0[s][fa], th[fa], addr[fa], old[fa]))

        # ALU: ADDI..HASHP, one fused select
        s = np.flatnonzero((op >= isa.ADDI) & (op <= isa.HASHP))
        if s.size:
            cases = tg0[s]
            o = op[s]
            hash_v = _w32(wa_base[cases]
                          + ((_w32(rb[s] * 127) ^ rc[s]) & wa_mask[cases]))
            hashp_v = _w32(wa_base[cases] + rc[s] * wa_size[cases]
                           + (_w32(rb[s] * 127) & wa_mask[cases]))
            val = np.select(
                [o == isa.ADDI, o == isa.MOVI, o == isa.MOV, o == isa.SUB,
                 o == isa.MULI, o == isa.ANDI, o == isa.HASH],
                [_w32(rb[s] + imm[s]), imm[s], rb[s], _w32(rb[s] - rc[s]),
                 _w32(rb[s] * imm[s]), rb[s] & imm[s], hash_v],
                default=hashp_v)
            wr(s, a[s], val)

        # Branches: BEQ..JMP, one fused compare
        s = np.flatnonzero((op >= isa.BEQ) & (op <= isa.JMP))
        if s.size:
            kind = op[s] - isa.BEQ
            rhs = np.where(kind < 4, rb[s], c_[s])
            cmpk = kind & 3
            lhs = ra[s]
            taken = np.select(
                [kind == 8, cmpk == 0, cmpk == 1, cmpk == 2],
                [True, lhs == rhs, lhs != rhs, lhs <= rhs],
                default=lhs > rhs)
            new_pc[s] = np.where(taken, imm[s], new_pc[s])
            if collect_coverage and taken.any():
                np.add.at(branch_taken, (tg0[s][taken], kind[taken]), 1)

        # WORKI / WORKR
        s = np.flatnonzero((op == isa.WORKI) | (op == isa.WORKR))
        if s.size:
            cost[s] = np.maximum(np.where(op[s] == isa.WORKI, imm[s], ra[s]),
                                 1)

        # PRNG
        s = np.flatnonzero(op == isa.PRNG)
        if s.size:
            cases, th = tg0[s], th0[s]
            sd = (prng[cases, th] * 1664525 + 1013904223) & 0xFFFFFFFF
            wr(s, a[s], (sd >> 16) % np.maximum(imm[s], 1))
            prng[cases, th] = sd

        # SPINs
        s = np.flatnonzero(((op >= isa.SPIN_EQ) & (op <= isa.SPIN_NEI))
                           | (op == isa.SPIN_GE))
        if s.size:
            s, addr = memaddr(s, rb[s])
        if s.size:
            cases, th = tg0[s], th0[s]
            ln = addr >> isa.LINE_SHIFT
            cost[s] = load_cost(cases, th, ln)[0]
            val = mem[cases, addr]
            o = op[s]
            proceed = np.select(
                [o == isa.SPIN_EQ, o == isa.SPIN_NE, o == isa.SPIN_EQI,
                 o == isa.SPIN_NEI],
                [val == ra[s], val != ra[s], val == c_[s], val != c_[s]],
                default=_w32(val - ra[s]) >= 0)  # wrap-safe frontier compare
            sharers[cases, ln, th] = True
            fail = ~proceed
            if fail.any():
                new_pc[s[fail]] = tpc0[s[fail]]
                sleep[s[fail]] = True
                spin_addr[cases[fail], th[fail]] = addr[fail]
                if collect_coverage:
                    skind = np.where(o == isa.SPIN_GE, N_SPIN_KINDS - 1,
                                     o - isa.SPIN_EQ)
                    np.add.at(spin_sleep, (cases[fail], skind[fail]), 1)

        # ACQ
        s = np.flatnonzero(op == isa.ACQ)
        if s.size:
            lidx = ra[s]
            bad = (lidx < -L) | (lidx >= L)
            if bad.any():
                _defer(tg0[s[bad]])
                dead[s[bad]] = True
                s, lidx = s[~bad], lidx[~bad]
            if s.size:
                cases, th = tg0[s], th0[s]
                rt = rel_time[cases, lidx]
                waited = c_[s] > 0
                got = waited & (rt >= 0)
                acq[cases, th] += 1
                if waited.any():
                    waited_acq[cases[waited], th[waited]] += 1
                if got.any():
                    cg2 = cases[got]
                    hand_sum[cg2] = _w32(hand_sum[cg2]
                                         + tnow0[s][got] - rt[got])
                    hand_cnt[cg2] += 1
                    rel_time[cg2, lidx[got]] = -1
                # consume pending TSTART marks into the log2 latency
                # histogram (same bucket formula as the engine/oracle);
                # each case executes at most one thread op per lockstep
                # iteration, so plain fancy-index increments are exact
                t0 = acq_t0[cases, th]
                marked = t0 >= 0
                if marked.any():
                    cm_ = cases[marked]
                    blat = np.maximum(_w32(tnow0[s][marked] - t0[marked]), 0)
                    bucket = (blat[:, None]
                              >= (np.int64(1)
                                  << np.arange(N_LAT_BUCKETS - 1,
                                               dtype=np.int64))).sum(1)
                    lat_hist[cm_, bucket] += 1
                    acq_t0[cm_, th[marked]] = -1
                if collect_trace:
                    acq_buf.append((cases, events[cases], tnow0[s], th,
                                    lidx, waited, regs[cases, th, isa.R_TX]))

        # TSTART — mark acquisition start for the latency histogram
        s = np.flatnonzero(op == isa.TSTART)
        if s.size:
            acq_t0[tg0[s], th0[s]] = tnow0[s]

        # REL
        s = np.flatnonzero(op == isa.REL)
        if s.size:
            lidx = rb[s]
            bad = (lidx < -L) | (lidx >= L)
            if bad.any():
                _defer(tg0[s[bad]])
                dead[s[bad]] = True
                s, lidx = s[~bad], lidx[~bad]
            if s.size:
                rel_time[tg0[s], lidx] = tnow0[s]

        # HALT
        s = np.flatnonzero(op == isa.HALT)
        if s.size:
            cost[s] = INF
            new_pc[s] = tpc0[s]

        # unknown opcodes: the sequential oracle raises; defer
        s = np.flatnonzero((op < 0) | (op >= isa.N_OPS))
        if s.size:
            _defer(tg0[s])
            dead[s] = True

        # --- writeback -----------------------------------------------------
        ok = ~dead
        if ok.any():
            sk = np.flatnonzero(ok)
            pc[tg0[sk], th0[sk]] = new_pc[sk]
            next_time[tg0[sk], th0[sk]] = np.where(
                sleep[sk], INF, _w32(tnow0[sk] + cost[sk]))

    # --- assemble per-case outputs -----------------------------------------
    stats: list = [None] * B
    traces: list | None = [None] * B if collect_trace else None
    fb = np.flatnonzero(fallback)
    for i in fb:
        tr = Trace() if collect_trace else None
        out = run_oracle(scenarios[i].program, trace=tr, mutate=mutate,
                         **scenarios[i].engine_kwargs())
        stats[i] = out
        if collect_trace:
            traces[i] = tr
    ok_cases = np.flatnonzero(~fallback)
    acq32 = acq.astype(np.int32)
    wacq32 = waited_acq.astype(np.int32)
    mem32 = mem.astype(np.int32)
    lat32 = lat_hist.astype(np.int32)
    sleeping = (spin_addr >= 0).sum(1)
    for i in ok_cases:
        stats[i] = {
            "acquisitions": acq32[i],
            "waited_acquisitions": wacq32[i],
            "handover_sum": np.int32(hand_sum[i]),
            "handover_count": np.int32(hand_cnt[i]),
            "events": np.int32(events[i]),
            "sleeping": np.int32(sleeping[i]),
            "grant_value": mem32[i],
            "lat_hist": lat32[i],
        }
    if collect_trace:
        fb_set = set(fb.tolist())
        for i in ok_cases:
            tr = Trace()
            tr.exit_reason = _EXIT_NAMES[int(exit_code[i])]
            tr.final_spin_addr = spin_addr[i].tolist()
            tr.final_pc = pc[i].tolist()
            tr.final_regs = regs[i].tolist()
            traces[i] = tr
        for buf, attr in ((acq_buf, "acquires"), (fadd_buf, "fadds")):
            if not buf:
                continue
            cols = [np.concatenate(col) for col in zip(*buf)]
            case_col = cols[0].tolist()
            rows = zip(*(c.tolist() for c in cols[1:]))
            for cse, row in zip(case_col, rows):
                if cse not in fb_set:
                    getattr(traces[cse], attr).append(row)
    coverage = None
    if collect_coverage:
        for arr in (op_exec, branch_taken, spin_sleep, commits_cov,
                    wakes_cov, wraps_cov):
            arr[fallback] = 0
        coverage = dict(op_exec=op_exec, branch_taken=branch_taken,
                        spin_sleep=spin_sleep, commits=commits_cov,
                        wakes=wakes_cov, wraps=wraps_cov)
    return BatchOracleResult(stats=stats, traces=traces, coverage=coverage,
                             fallbacks=fallback)


def _run_batch_c(scenarios, mutate, collect_trace,
                 collect_coverage) -> BatchOracleResult:
    """Drive the whole batch through the compiled per-case kernel."""
    lib = _fastcase.LIB
    B = len(scenarios)
    s0 = scenarios[0]
    T, M, L = s0.n_threads, s0.mem_words, s0.n_locks
    i32 = np.int32

    P = np.asarray(s0.program).shape[0]
    n_costs = np.asarray(s0.costs).shape[0]
    prog = np.empty((B, P, 5), i32)
    pc0 = np.empty((B, T), i32)
    regs0 = np.empty((B, T, isa.N_REGS), i32)
    mem0 = np.empty((B, M), i32)
    costs = np.empty((B, n_costs), i32)
    scal = np.empty((B, 6), np.int64)
    for i, s in enumerate(scenarios):
        prog[i] = s.program
        pc0[i] = s.init_pc
        regs0[i] = s.init_regs
        mem0[i] = s.init_mem
        costs[i] = s.costs
        scal[i] = (T if s.n_active is None else s.n_active, s.seed,
                   s.wa_base, s.wa_size, s.horizon, s.max_events)
    n_active = np.ascontiguousarray(scal[:, 0], i32)
    seeds = np.ascontiguousarray(scal[:, 1])
    wa_base = np.ascontiguousarray(scal[:, 2], i32)
    wa_size = np.ascontiguousarray(scal[:, 3], i32)
    horizon = np.ascontiguousarray(scal[:, 4], i32)
    max_events = np.ascontiguousarray(scal[:, 5], i32)
    mut = 0
    for m in mutate:
        mut |= _fastcase.MUTATION_FLAGS[m]

    scheds = [scenario_faults(s) for s in scenarios]
    n_faults = max((len(sc) for sc in scheds if sc is not None), default=0)
    if n_faults:
        fk = np.zeros((B, n_faults), i32)
        fe = np.zeros((B, n_faults), i32)
        ft = np.zeros((B, n_faults), i32)
        fa = np.zeros((B, n_faults), i32)
        for i, sc in enumerate(scheds):
            if sc is not None and len(sc):
                fk[i], fe[i], ft[i], fa[i] = sc.padded(n_faults)
    else:
        fk = fe = ft = fa = None

    out_acq = np.zeros((B, T), i32)
    out_waited = np.zeros((B, T), i32)
    out_scalars = np.zeros((B, 5), i32)
    out_mem = np.zeros((B, M), i32)
    out_lathist = np.zeros((B, N_LAT_BUCKETS), i32)
    out_spin = np.zeros((B, T), i32)
    out_pc = np.zeros((B, T), i32)
    out_regs = np.zeros((B, T, isa.N_REGS), i32)
    rets = np.zeros(B, i32)
    toff = np.zeros((B, 2), np.int64)
    tcnt = np.zeros((B, 2), i32)
    if collect_trace:
        # Pooled capacity, ~4x the observed mean rows/case; a case that
        # would overflow the pool becomes a sequential fallback (ret=3),
        # which is bit-identical by construction.  np.empty is safe: only
        # rows the kernel wrote are ever read back.
        acq_cap = B * 64 + 8192
        fadd_cap = B * 64 + 8192
        acq_trace = np.empty((acq_cap, 6), i32)
        fadd_trace = np.empty((fadd_cap, 5), i32)
    else:
        acq_cap = fadd_cap = 0
        acq_trace = fadd_trace = None
    if collect_coverage:
        cov_op = np.zeros((B, isa.N_OPS), i32)
        cov_branch = np.zeros((B, N_BRANCH_KINDS), i32)
        cov_spin = np.zeros((B, N_SPIN_KINDS), i32)
        cov_scalars = np.zeros((B, 3), i32)
    else:
        cov_op = cov_branch = cov_spin = cov_scalars = None

    def p32(arr):
        return None if arr is None else arr.ctypes.data_as(_fastcase.I32P)

    lib.run_cases(
        B, p32(prog), P, T, M, L, p32(pc0), p32(regs0), p32(mem0),
        p32(n_active), seeds.ctypes.data_as(_fastcase.I64P),
        p32(wa_base), p32(wa_size), p32(horizon), p32(max_events),
        p32(costs), mut,
        p32(fk), p32(fe), p32(ft), p32(fa), n_faults,
        p32(out_acq), p32(out_waited), p32(out_scalars), p32(out_mem),
        p32(out_lathist), p32(out_spin), p32(out_pc), p32(out_regs),
        p32(rets),
        p32(acq_trace), acq_cap, p32(fadd_trace), fadd_cap,
        toff.ctypes.data_as(_fastcase.I64P), p32(tcnt),
        p32(cov_op), p32(cov_branch), p32(cov_spin), p32(cov_scalars))

    if (rets == 2).any():
        raise MemoryError("fastcase kernel allocation failure")
    fallback = rets != 0
    stats: list = [None] * B
    traces: list | None = [None] * B if collect_trace else None
    for i in np.flatnonzero(fallback):
        tr = Trace() if collect_trace else None
        stats[i] = run_oracle(scenarios[i].program, trace=tr, mutate=mutate,
                              **scenarios[i].engine_kwargs())
        if collect_trace:
            traces[i] = tr
    if collect_trace:
        # One bulk conversion (zip builds the tuples in C); per-case slices
        # of the Python lists below use plain-int offsets and are cheap.
        at = acq_trace[:int(tcnt[:, 0].sum())]
        acq_rows = list(zip(at[:, 0].tolist(), at[:, 1].tolist(),
                            at[:, 2].tolist(), at[:, 3].tolist(),
                            (at[:, 4] != 0).tolist(), at[:, 5].tolist()))
        ft = fadd_trace[:int(tcnt[:, 1].sum())]
        fadd_rows = list(zip(ft[:, 0].tolist(), ft[:, 1].tolist(),
                             ft[:, 2].tolist(), ft[:, 3].tolist(),
                             ft[:, 4].tolist()))
        toff_l = toff.tolist()
        tcnt_l = tcnt.tolist()
        exit_l = out_scalars[:, 4].tolist()
    hs, hc, ev_a, sl = (out_scalars[:, 0], out_scalars[:, 1],
                        out_scalars[:, 2], out_scalars[:, 3])
    new_trace = Trace.__new__  # bypass default-list construction
    for i in np.flatnonzero(~fallback).tolist():
        stats[i] = {
            "acquisitions": out_acq[i],
            "waited_acquisitions": out_waited[i],
            "handover_sum": hs[i],
            "handover_count": hc[i],
            "events": ev_a[i],
            "sleeping": sl[i],
            "grant_value": out_mem[i],
            "lat_hist": out_lathist[i],
        }
        if collect_trace:
            tr = new_trace(Trace)
            tr.exit_reason = _EXIT_NAMES[exit_l[i]]
            ao, fo = toff_l[i]
            an, fn = tcnt_l[i]
            tr.acquires = acq_rows[ao:ao + an]
            tr.fadds = fadd_rows[fo:fo + fn]
            tr.faults_applied = []
            tr.final_spin_addr = out_spin[i].tolist()
            tr.final_pc = out_pc[i].tolist()
            tr.final_regs = out_regs[i].tolist()
            traces[i] = tr
    coverage = None
    if collect_coverage:
        for arr in (cov_op, cov_branch, cov_spin, cov_scalars):
            arr[fallback] = 0
        c64 = cov_scalars.astype(np.int64)
        coverage = dict(op_exec=cov_op.astype(np.int64),
                        branch_taken=cov_branch.astype(np.int64),
                        spin_sleep=cov_spin.astype(np.int64),
                        commits=c64[:, 0], wakes=c64[:, 1],
                        wraps=c64[:, 2])
    return BatchOracleResult(stats=stats, traces=traces, coverage=coverage,
                             fallbacks=fallback)


__all__ = ["run_batch_oracle", "BatchOracleResult",
           "N_BRANCH_KINDS", "N_SPIN_KINDS"]
