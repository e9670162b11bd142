"""Compiled C fast path for the batch oracle.

The sequential oracle costs ~3 microseconds of Python per event; the NumPy
lockstep interpreter in :mod:`batch_oracle` amortizes that to ~0.5 us but
keeps a per-iteration fancy-indexing floor far above the fuzz-scale target.
This module compiles (once, cached by source hash) a small C translation of
the exact ``oracle.run_oracle`` event loop and drives a whole padded batch
through it with a single ``ctypes`` call — no new dependencies, just the
toolchain ``cc``.  The library is built at first use (the first read of
``LIB`` or ``HAVE_FAST``) into the port's build directory, ``build/`` at
the root of the checkout or ``$REPRO_TORCH_BUILD_DIR``, beside the CUDA
kernels.  This is a host-side referee, so when no C compiler is available
``LIB`` is ``None`` and the batch oracle takes its NumPy lockstep path; a
run reports which one it used (:func:`repro_torch.sim.check.oracle_impl`).

Faithfulness contract (same as batch_oracle.py, differentially pinned by
``tests/test_check_batch_oracle.py`` in the reference package and
``tests/test_torch_check.py`` here):

  * int32 two's-complement wrap everywhere (``w32``), matching ``_w32``;
  * event selection is the same strict-``<`` first-minimum scan; a
    commit/thread tie resolves to the commit, within-half ties to the
    lowest thread index;
  * ``pend_addr``/``spin_addr`` keep RAW addresses (commit-presence is
    ``>= 0``, wakeups compare raw values);
  * fault schedules (``repro_torch.sim.faults``) apply under the extended
    ``EVENT_ORDER_CONTRACT``: mutate persisted state after the stop check,
    re-select the event, and skip the step (counter unchanged) when the
    post-fault earliest time reaches the horizon; woken threads pay their
    accumulated ``wake_delay`` on top of ``C_WAKE``;
  * in-range negative memory/pc/lock indices wrap once like Python lists;
    anything outside ``[-N, N)`` (or an unknown opcode) returns 1 and the
    caller re-runs the case on the sequential oracle, reproducing the
    reference behaviour including the exception it would raise;
  * the ISA/cost/register constants are formatted into the C source from
    the Python definitions when it is built, so they cannot drift.

Per-case return codes: 0 ok, 1 sequential-oracle fallback needed,
2 allocation failure, 3 trace buffer full (also a fallback — the caller's
capacity heuristic keeps this rare).  The kernel optionally fills the
coverage counters ``coverage.py`` consumes (opcode execution, taken
branches, failed-spin parks, commits, wakeups, RMW sign flips).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess

from ... import _build
from .. import isa
from ..costs import (I_ATOMIC, I_HIT, I_INV, I_LOCAL, I_MISS, I_ST_OWNED,
                     I_ST_SHARED, I_WAKE, I_XFER)
from ..engine import N_LAT_BUCKETS
from ..faults import F_ABORT, F_PREEMPT, F_SPURIOUS
from .oracle import INF as _INF

# Mutation bit flags (keep in sync with the #defines below).
MUTATION_FLAGS = {"eager_store": 1, "lost_wake": 2, "free_invalidation": 4,
                  "dropped_fault": 8}

_C_TEMPLATE = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define INF        %(INF)d
#define N_REGS     %(N_REGS)d
#define LINE_SHIFT %(LINE_SHIFT)d
#define R_TX       %(R_TX)d
#define I_LOCAL    %(I_LOCAL)d
#define I_HIT      %(I_HIT)d
#define I_MISS     %(I_MISS)d
#define I_XFER     %(I_XFER)d
#define I_ST_OWNED %(I_ST_OWNED)d
#define I_ST_SHARED %(I_ST_SHARED)d
#define I_INV      %(I_INV)d
#define I_ATOMIC   %(I_ATOMIC)d
#define I_WAKE     %(I_WAKE)d
#define N_COSTS    %(N_COSTS)d

#define OP_NOP      %(NOP)d
#define OP_LOAD     %(LOAD)d
#define OP_STORE    %(STORE)d
#define OP_STOREI   %(STOREI)d
#define OP_FADD     %(FADD)d
#define OP_SWAP     %(SWAP)d
#define OP_CASZ     %(CASZ)d
#define OP_ADDI     %(ADDI)d
#define OP_MOVI     %(MOVI)d
#define OP_MOV      %(MOV)d
#define OP_SUB      %(SUB)d
#define OP_MULI     %(MULI)d
#define OP_ANDI     %(ANDI)d
#define OP_HASH     %(HASH)d
#define OP_HASHP    %(HASHP)d
#define OP_BEQ      %(BEQ)d
#define OP_JMP      %(JMP)d
#define OP_WORKI    %(WORKI)d
#define OP_WORKR    %(WORKR)d
#define OP_PRNG     %(PRNG)d
#define OP_SPIN_EQ  %(SPIN_EQ)d
#define OP_SPIN_NE  %(SPIN_NE)d
#define OP_SPIN_EQI %(SPIN_EQI)d
#define OP_SPIN_NEI %(SPIN_NEI)d
#define OP_SPIN_GE  %(SPIN_GE)d
#define OP_ACQ      %(ACQ)d
#define OP_REL      %(REL)d
#define OP_HALT     %(HALT)d
#define OP_TSTART   %(TSTART)d
#define N_OPS       %(N_OPS)d
#define N_LAT_BUCKETS %(N_LAT_BUCKETS)d
#define N_BRANCH_KINDS %(N_BRANCH_KINDS)d
#define N_SPIN_KINDS   %(N_SPIN_KINDS)d

#define MUT_EAGER   1
#define MUT_LOST    2
#define MUT_FREEINV 4
#define MUT_DROPFAULT 8

#define F_PREEMPT  %(F_PREEMPT)d
#define F_SPURIOUS %(F_SPURIOUS)d
#define F_ABORT    %(F_ABORT)d

static inline int32_t w32(int64_t v) { return (int32_t)(uint64_t)v; }

/* Event selection (EVENT_ORDER_CONTRACT): earliest pending commit and
 * earliest thread time, first minimum == lowest thread index.  Factored
 * out because the fault phase re-selects from the post-fault state. */
static inline int32_t select_event(int T, int npend,
        const int32_t *pend_addr, const int32_t *pend_time,
        const int32_t *next_time,
        int32_t *t_cm_out, int *tc_out, int32_t *t_th_out, int *tt_out) {
    int32_t t_cm = INF, t_th = INF;
    int tc = 0, tt = 0;
    if (npend)
        for (int u = 0; u < T; u++)
            if (pend_addr[u] >= 0 && pend_time[u] < t_cm) {
                t_cm = pend_time[u]; tc = u;
            }
    if (T == 8) {  /* the padded fuzz width: unrollable/vectorizable */
        int32_t m = next_time[0];
        for (int u = 1; u < 8; u++) if (next_time[u] < m) m = next_time[u];
        for (int u = 0; u < 8; u++)
            if (next_time[u] == m) { tt = u; break; }
        t_th = m;
    } else {
        for (int u = 0; u < T; u++)
            if (next_time[u] < t_th) { t_th = next_time[u]; tt = u; }
    }
    *t_cm_out = t_cm; *tc_out = tc; *t_th_out = t_th; *tt_out = tt;
    return t_cm < t_th ? t_cm : t_th;
}

/* Register GATHER index: wrap one negative step, then clamp to [0, 16). */
static inline int rd(int32_t idx) {
    if (idx < 0) idx += N_REGS;
    return idx < 0 ? 0 : (idx >= N_REGS ? N_REGS - 1 : idx);
}

/* Register SCATTER: wrap once, DROP the write when still out of range. */
static inline void wrreg(int32_t *R, int32_t idx, int32_t val) {
    if (idx < 0) idx += N_REGS;
    if (idx >= 0 && idx < N_REGS) R[idx] = val;
}

int run_case(
    const int32_t *prog, int32_t prog_len,
    int32_t T, int32_t M, int32_t L,
    const int32_t *init_pc, const int32_t *init_regs,
    const int32_t *init_mem,
    int32_t n_active, int64_t seed,
    int32_t wa_base, int32_t wa_size,
    int32_t horizon, int32_t max_events,
    const int32_t *costs, int32_t mut,
    /* fault schedule: (n_faults,) each, kind 0 = pad; NULL when none */
    const int32_t *f_kind, const int32_t *f_evt,
    const int32_t *f_tid, const int32_t *f_arg, int32_t n_faults,
    /* outputs */
    int32_t *out_acq, int32_t *out_waited,         /* (T,) each */
    int32_t *out_scalars,  /* [hand_sum, hand_cnt, events, sleeping, exit] */
    int32_t *out_mem,                              /* (M,) */
    int32_t *out_lathist,                          /* (N_LAT_BUCKETS,) */
    int32_t *out_spin, int32_t *out_pc,            /* (T,) each */
    int32_t *out_regs,                             /* (T, N_REGS) */
    int32_t *acq_trace, int64_t acq_cap,           /* (acq_cap, 6) or NULL */
    int32_t *fadd_trace, int64_t fadd_cap,         /* (fadd_cap, 5) or NULL */
    int32_t *trace_counts,                         /* [n_acq, n_fadd] */
    int32_t *cov_op,      /* (N_OPS,) or NULL */
    int32_t *cov_branch,  /* (N_BRANCH_KINDS,) or NULL */
    int32_t *cov_spin,    /* (N_SPIN_KINDS,) or NULL */
    int32_t *cov_scalars  /* [commits, wakes, wraps] or NULL */
) {
    const int n_lines = M >> LINE_SHIFT;
    const int32_t wa_mask = wa_size - 1;
    int ret = 0;
    int32_t hand_sum = 0, hand_cnt = 0, events = 0;
    int32_t nacq = 0, nfadd = 0, exit_code = 0;

    int32_t *mem = (int32_t *)malloc((size_t)M * 4);
    int32_t *regs = (int32_t *)malloc((size_t)T * N_REGS * 4);
    int32_t *pcv = (int32_t *)malloc((size_t)T * 4);
    int32_t *next_time = (int32_t *)malloc((size_t)T * 4);
    int32_t *pend_addr = (int32_t *)malloc((size_t)T * 4);
    int32_t *pend_val = (int32_t *)malloc((size_t)T * 4);
    int32_t *pend_time = (int32_t *)malloc((size_t)T * 4);
    int32_t *spin = (int32_t *)malloc((size_t)T * 4);
    int32_t *wake_delay = (int32_t *)calloc((size_t)T, 4);
    uint32_t *prngv = (uint32_t *)malloc((size_t)T * 4);
    int32_t *dirtyv = (int32_t *)malloc((size_t)n_lines * 4);
    uint64_t *sharers = (uint64_t *)calloc((size_t)n_lines, 8);
    int32_t *relt = (int32_t *)malloc((size_t)L * 4);
    int32_t *acq_t0 = (int32_t *)malloc((size_t)T * 4);
    if (!mem || !regs || !pcv || !next_time || !pend_addr || !pend_val ||
        !pend_time || !spin || !wake_delay || !prngv || !dirtyv ||
        !sharers || !relt || !acq_t0) {
        ret = 2;
        goto done;
    }
    memcpy(mem, init_mem, (size_t)M * 4);
    memcpy(regs, init_regs, (size_t)T * N_REGS * 4);
    memcpy(pcv, init_pc, (size_t)T * 4);
    for (int t = 0; t < T; t++) {
        next_time[t] = t < n_active ? 0 : INF;
        pend_addr[t] = -1;
        pend_val[t] = 0;
        pend_time[t] = 0;
        spin[t] = -1;
        prngv[t] = (uint32_t)(uint64_t)(seed + (int64_t)t * 2654435761LL);
        acq_t0[t] = -1;
        out_acq[t] = 0;
        out_waited[t] = 0;
    }
    for (int i = 0; i < N_LAT_BUCKETS; i++) out_lathist[i] = 0;
    for (int i = 0; i < n_lines; i++) dirtyv[i] = -1;
    for (int i = 0; i < L; i++) relt[i] = -1;
    int npend = 0;  /* count of commit-visible (>= 0) pending stores */

    for (;;) {
        /* --- event selection (EVENT_ORDER_CONTRACT) -------------------- */
        int32_t t_cm, t_th;
        int tc, tt;
        int32_t now = select_event(T, npend, pend_addr, pend_time,
                                   next_time, &t_cm, &tc, &t_th, &tt);
        if (!(events < max_events && now < horizon)) {
            if (events >= max_events) exit_code = 1;
            else if (now < INF) exit_code = 2;
            else {
                int anyspin = 0;
                for (int u = 0; u < T; u++) if (spin[u] >= 0) anyspin = 1;
                exit_code = anyspin ? 3 : 4;
            }
            break;
        }
        /* --- fault phase (extended contract): an entry matching the
         * current event counter mutates persisted state, then the event is
         * re-selected; past-horizon means no event executes this step and
         * the counter does not advance. */
        if (n_faults && !(mut & MUT_DROPFAULT)) {
            int applied = 0;
            for (int f = 0; f < n_faults; f++) {
                if (f_kind[f] != 0 && f_evt[f] == events) {
                    int u = f_tid[f];
                    if (f_kind[f] == F_PREEMPT) {
                        if (next_time[u] < INF)
                            next_time[u] =
                                w32((int64_t)next_time[u] + f_arg[f]);
                        else
                            wake_delay[u] =
                                w32((int64_t)wake_delay[u] + f_arg[f]);
                    } else if (f_kind[f] == F_SPURIOUS) {
                        if (spin[u] >= 0) {
                            next_time[u] = w32((int64_t)now + costs[I_WAKE]
                                               + wake_delay[u]);
                            wake_delay[u] = 0;
                            spin[u] = -1;
                        }
                    } else {  /* F_ABORT: dead, never wakeable */
                        next_time[u] = INF;
                        spin[u] = -1;
                    }
                    applied = 1;
                    break;  /* event indices are unique per schedule */
                }
            }
            if (applied) {
                now = select_event(T, npend, pend_addr, pend_time,
                                   next_time, &t_cm, &tc, &t_th, &tt);
                if (now >= horizon) continue;
            }
        }
        events++;

        if (t_cm <= t_th) {  /* commit wins the tie */
            int t = tc;
            int32_t addr = pend_addr[t];  /* >= 0 and < M: checked at issue */
            int ln = addr >> LINE_SHIFT;
            mem[addr] = pend_val[t];
            sharers[ln] = 1ULL << t;
            dirtyv[ln] = t;
            pend_addr[t] = -1;
            npend--;
            if (cov_scalars) cov_scalars[0]++;
            if (!(mut & MUT_LOST)) {
                int32_t resume = w32((int64_t)now + costs[I_WAKE]);
                for (int u = 0; u < T; u++)
                    if (spin[u] == addr) {
                        next_time[u] = w32((int64_t)resume + wake_delay[u]);
                        wake_delay[u] = 0;
                        spin[u] = -1;
                        if (cov_scalars) cov_scalars[1]++;
                    }
            }
            continue;
        }

        /* --- thread half: execute one instruction ----------------------- */
        int t = tt;
        int32_t *R = regs + (size_t)t * N_REGS;
        int32_t pc0 = pcv[t];
        int32_t pidx = pc0 < 0 ? pc0 + prog_len : pc0;
        if (pidx < 0 || pidx >= prog_len) { ret = 1; goto done; }
        const int32_t *I = prog + (size_t)pidx * 5;
        int32_t op = I[0], A = I[1], B = I[2], C = I[3], imm = I[4];
        int32_t ra = R[rd(A)], rb = R[rd(B)], rc = R[rd(C)];
        int32_t new_pc = pc0 + 1;
        int32_t cost = costs[I_LOCAL];
        int sleepf = 0;
        if (cov_op && op >= 0 && op < N_OPS) cov_op[op]++;

        if (op >= OP_BEQ && op <= OP_JMP) {
            int kind = op - OP_BEQ;
            int32_t rhs = kind < 4 ? rb : C;
            int cmpk = kind & 3;
            int taken;
            if (kind == 8) taken = 1;
            else if (cmpk == 0) taken = ra == rhs;
            else if (cmpk == 1) taken = ra != rhs;
            else if (cmpk == 2) taken = ra <= rhs;
            else taken = ra > rhs;
            if (taken) {
                new_pc = imm;
                if (cov_branch) cov_branch[kind]++;
            }
        } else switch (op) {
        case OP_NOP:
            break;
        case OP_LOAD: {
            int32_t addr = w32((int64_t)rb + imm);
            if (addr < -M || addr >= M) { ret = 1; goto done; }
            int32_t eff = addr < 0 ? addr + M : addr;
            int ln = eff >> LINE_SHIFT;
            int mine = (int)((sharers[ln] >> t) & 1ULL);
            int32_t d = dirtyv[ln];
            cost = mine ? costs[I_HIT]
                        : (d >= 0 && d != t ? costs[I_XFER] : costs[I_MISS]);
            if (!mine && d >= 0 && d != t) dirtyv[ln] = -1;
            wrreg(R, A, mem[eff]);
            sharers[ln] |= 1ULL << t;
            break;
        }
        case OP_STORE:
        case OP_STOREI: {
            int32_t addr = w32((int64_t)ra + imm);
            if (addr < -M || addr >= M) { ret = 1; goto done; }
            int32_t eff = addr < 0 ? addr + M : addr;
            int ln = eff >> LINE_SHIFT;
            uint64_t row = sharers[ln];
            int mine = (int)((row >> t) & 1ULL);
            int others = __builtin_popcountll(row) - mine;
            cost = (mine && others == 0)
                       ? costs[I_ST_OWNED]
                       : costs[I_ST_SHARED] +
                             ((mut & MUT_FREEINV) ? 0 : costs[I_INV] * others);
            int32_t val = op == OP_STORE ? rb : B;
            if (pend_addr[t] >= 0) npend--;  /* overwrite a visible entry */
            pend_addr[t] = addr;  /* RAW address */
            if (addr >= 0) npend++;
            pend_val[t] = val;
            pend_time[t] = w32((int64_t)now + cost);
            if (mut & MUT_EAGER) mem[eff] = val;
            break;
        }
        case OP_FADD:
        case OP_SWAP:
        case OP_CASZ: {
            int32_t addr = w32((int64_t)rb + imm);
            if (addr < -M || addr >= M) { ret = 1; goto done; }
            int32_t eff = addr < 0 ? addr + M : addr;
            int ln = eff >> LINE_SHIFT;
            uint64_t row = sharers[ln];
            int mine = (int)((row >> t) & 1ULL);
            int others = __builtin_popcountll(row) - mine;
            cost = ((mine && others == 0)
                        ? costs[I_ST_OWNED]
                        : costs[I_ST_SHARED] +
                              ((mut & MUT_FREEINV) ? 0
                                                   : costs[I_INV] * others)) +
                   costs[I_ATOMIC];
            int32_t old = mem[eff];
            int32_t newv;
            if (op == OP_FADD) newv = w32((int64_t)old + C);
            else if (op == OP_SWAP) newv = rc;
            else newv = old == rc ? 0 : old;
            wrreg(R, A, old);
            mem[eff] = newv;
            sharers[ln] = 1ULL << t;
            dirtyv[ln] = t;
            {
                int32_t resume = w32((int64_t)w32((int64_t)now + cost) +
                                     costs[I_WAKE]);
                for (int u = 0; u < T; u++)
                    if (spin[u] == addr) {  /* RAW address compare */
                        next_time[u] = w32((int64_t)resume + wake_delay[u]);
                        wake_delay[u] = 0;
                        spin[u] = -1;
                        if (cov_scalars) cov_scalars[1]++;
                    }
            }
            if (cov_scalars && ((old < 0) != (newv < 0))) cov_scalars[2]++;
            if (op == OP_FADD && fadd_trace) {
                if (nfadd >= fadd_cap) { ret = 3; goto done; }
                int32_t *r = fadd_trace + (size_t)nfadd * 5;
                r[0] = events; r[1] = now; r[2] = t; r[3] = addr; r[4] = old;
                nfadd++;
            }
            break;
        }
        case OP_ADDI: wrreg(R, A, w32((int64_t)rb + imm)); break;
        case OP_MOVI: wrreg(R, A, imm); break;
        case OP_MOV:  wrreg(R, A, rb); break;
        case OP_SUB:  wrreg(R, A, w32((int64_t)rb - rc)); break;
        case OP_MULI: wrreg(R, A, w32((int64_t)rb * imm)); break;
        case OP_ANDI: wrreg(R, A, rb & imm); break;
        case OP_HASH:
            wrreg(R, A, w32((int64_t)wa_base +
                            ((w32((int64_t)rb * 127) ^ rc) & wa_mask)));
            break;
        case OP_HASHP:
            wrreg(R, A, w32((int64_t)wa_base + (int64_t)rc * wa_size +
                            (w32((int64_t)rb * 127) & wa_mask)));
            break;
        case OP_WORKI: cost = imm > 1 ? imm : 1; break;
        case OP_WORKR: cost = ra > 1 ? ra : 1; break;
        case OP_PRNG: {
            uint32_t sd =
                (uint32_t)((uint64_t)prngv[t] * 1664525ULL + 1013904223ULL);
            uint32_t modv = imm > 1 ? (uint32_t)imm : 1u;
            wrreg(R, A, (int32_t)((sd >> 16) %% modv));
            prngv[t] = sd;
            break;
        }
        case OP_SPIN_EQ:
        case OP_SPIN_NE:
        case OP_SPIN_EQI:
        case OP_SPIN_NEI:
        case OP_SPIN_GE: {
            int32_t addr = w32((int64_t)rb + imm);
            if (addr < -M || addr >= M) { ret = 1; goto done; }
            int32_t eff = addr < 0 ? addr + M : addr;
            int ln = eff >> LINE_SHIFT;
            int mine = (int)((sharers[ln] >> t) & 1ULL);
            int32_t d = dirtyv[ln];
            cost = mine ? costs[I_HIT]
                        : (d >= 0 && d != t ? costs[I_XFER] : costs[I_MISS]);
            int32_t val = mem[eff];
            int proceed;
            switch (op) {
            case OP_SPIN_EQ: proceed = val == ra; break;
            case OP_SPIN_NE: proceed = val != ra; break;
            case OP_SPIN_EQI: proceed = val == C; break;
            case OP_SPIN_NEI: proceed = val != C; break;
            default: proceed = w32((int64_t)val - ra) >= 0; break;
            }
            sharers[ln] |= 1ULL << t;
            if (!proceed) {
                new_pc = pc0;
                sleepf = 1;
                spin[t] = addr;  /* RAW address */
                if (cov_spin)
                    cov_spin[op == OP_SPIN_GE ? N_SPIN_KINDS - 1
                                              : op - OP_SPIN_EQ]++;
            }
            break;
        }
        case OP_ACQ: {
            int32_t lidx = ra;
            int32_t li = lidx < 0 ? lidx + L : lidx;
            if (li < 0 || li >= L) { ret = 1; goto done; }
            int32_t rt = relt[li];
            int waited = C > 0;
            int got = waited && rt >= 0;
            out_acq[t]++;
            if (waited) out_waited[t]++;
            if (got) {
                hand_sum = w32((int64_t)hand_sum + now - rt);
                hand_cnt++;
                relt[li] = -1;
            }
            /* consume a pending TSTART mark into the log2 latency
             * histogram (same bucket formula as the engine/oracle) */
            if (acq_t0[t] >= 0) {
                int32_t blat = w32((int64_t)now - acq_t0[t]);
                if (blat < 0) blat = 0;
                int bkt = 0;
                while (bkt < N_LAT_BUCKETS - 1 && blat >= (1 << bkt)) bkt++;
                out_lathist[bkt]++;
                acq_t0[t] = -1;
            }
            if (acq_trace) {
                if (nacq >= acq_cap) { ret = 3; goto done; }
                int32_t *r = acq_trace + (size_t)nacq * 6;
                r[0] = events; r[1] = now; r[2] = t; r[3] = lidx;
                r[4] = waited; r[5] = R[R_TX];
                nacq++;
            }
            break;
        }
        case OP_REL: {
            int32_t lidx = rb;
            int32_t li = lidx < 0 ? lidx + L : lidx;
            if (li < 0 || li >= L) { ret = 1; goto done; }
            relt[li] = now;
            break;
        }
        case OP_HALT:
            cost = INF;
            new_pc = pc0;
            break;
        case OP_TSTART:
            acq_t0[t] = now;
            break;
        default:
            ret = 1;  /* unknown opcode: the sequential oracle raises */
            goto done;
        }
        pcv[t] = new_pc;
        next_time[t] = sleepf ? INF : w32((int64_t)now + cost);
    }

    {
        int32_t sleeping = 0;
        for (int u = 0; u < T; u++) if (spin[u] >= 0) sleeping++;
        out_scalars[0] = hand_sum;
        out_scalars[1] = hand_cnt;
        out_scalars[2] = events;
        out_scalars[3] = sleeping;
        out_scalars[4] = exit_code;
    }
    memcpy(out_mem, mem, (size_t)M * 4);
    memcpy(out_spin, spin, (size_t)T * 4);
    memcpy(out_pc, pcv, (size_t)T * 4);
    memcpy(out_regs, regs, (size_t)T * N_REGS * 4);

done:
    if (trace_counts) { trace_counts[0] = nacq; trace_counts[1] = nfadd; }
    free(mem); free(regs); free(pcv); free(next_time); free(pend_addr);
    free(pend_val); free(pend_time); free(spin); free(wake_delay);
    free(prngv); free(dirtyv); free(sharers); free(relt); free(acq_t0);
    return ret;
}

/* Batch driver: one ctypes call per padded batch.  Traces pack densely into
 * shared buffers; a case whose traces do not fit is marked ret=3 and its
 * rows are reclaimed (offsets only advance on success). */
int run_cases(
    int64_t n_cases,
    const int32_t *prog, int32_t prog_len,
    int32_t T, int32_t M, int32_t L,
    const int32_t *init_pc, const int32_t *init_regs,
    const int32_t *init_mem,
    const int32_t *n_active, const int64_t *seeds,
    const int32_t *wa_base, const int32_t *wa_size,
    const int32_t *horizon, const int32_t *max_events,
    const int32_t *costs, int32_t mut,
    const int32_t *f_kind, const int32_t *f_evt,      /* (n_cases, n_faults) */
    const int32_t *f_tid, const int32_t *f_arg,       /* each, or NULL */
    int32_t n_faults,
    int32_t *out_acq, int32_t *out_waited,
    int32_t *out_scalars, int32_t *out_mem, int32_t *out_lathist,
    int32_t *out_spin, int32_t *out_pc, int32_t *out_regs,
    int32_t *ret_codes,
    int32_t *acq_trace, int64_t acq_cap,
    int32_t *fadd_trace, int64_t fadd_cap,
    int64_t *trace_offsets,   /* (n_cases, 2) */
    int32_t *trace_counts,    /* (n_cases, 2) */
    int32_t *cov_op, int32_t *cov_branch, int32_t *cov_spin,
    int32_t *cov_scalars
) {
    int64_t acq_off = 0, fadd_off = 0;
    for (int64_t i = 0; i < n_cases; i++) {
        int32_t tc[2] = {0, 0};
        int r = run_case(
            prog + (size_t)i * prog_len * 5, prog_len, T, M, L,
            init_pc + (size_t)i * T, init_regs + (size_t)i * T * N_REGS,
            init_mem + (size_t)i * M,
            n_active[i], seeds[i], wa_base[i], wa_size[i],
            horizon[i], max_events[i], costs + (size_t)i * N_COSTS, mut,
            f_kind ? f_kind + (size_t)i * n_faults : 0,
            f_evt ? f_evt + (size_t)i * n_faults : 0,
            f_tid ? f_tid + (size_t)i * n_faults : 0,
            f_arg ? f_arg + (size_t)i * n_faults : 0,
            f_kind ? n_faults : 0,
            out_acq + (size_t)i * T, out_waited + (size_t)i * T,
            out_scalars + (size_t)i * 5, out_mem + (size_t)i * M,
            out_lathist + (size_t)i * N_LAT_BUCKETS,
            out_spin + (size_t)i * T, out_pc + (size_t)i * T,
            out_regs + (size_t)i * T * N_REGS,
            acq_trace ? acq_trace + acq_off * 6 : 0,
            acq_trace ? acq_cap - acq_off : 0,
            fadd_trace ? fadd_trace + fadd_off * 5 : 0,
            fadd_trace ? fadd_cap - fadd_off : 0,
            tc,
            cov_op ? cov_op + (size_t)i * N_OPS : 0,
            cov_branch ? cov_branch + (size_t)i * N_BRANCH_KINDS : 0,
            cov_spin ? cov_spin + (size_t)i * N_SPIN_KINDS : 0,
            cov_scalars ? cov_scalars + (size_t)i * 3 : 0);
        ret_codes[i] = r;
        if (r == 0) {
            trace_offsets[i * 2] = acq_off;
            trace_offsets[i * 2 + 1] = fadd_off;
            trace_counts[i * 2] = tc[0];
            trace_counts[i * 2 + 1] = tc[1];
            acq_off += tc[0];
            fadd_off += tc[1];
        } else {
            trace_offsets[i * 2] = -1;
            trace_offsets[i * 2 + 1] = -1;
            trace_counts[i * 2] = 0;
            trace_counts[i * 2 + 1] = 0;
        }
    }
    return 0;
}
"""


def _c_source() -> str:
    # Mirrors batch_oracle.N_BRANCH_KINDS / N_SPIN_KINDS (computed locally
    # to avoid a circular import during the module-level build).
    subs = {name: getattr(isa, name) for name in (
        "N_REGS", "LINE_SHIFT", "R_TX", "NOP", "LOAD", "STORE", "STOREI",
        "FADD", "SWAP", "CASZ", "ADDI", "MOVI", "MOV", "SUB", "MULI",
        "ANDI", "HASH", "HASHP", "BEQ", "JMP", "WORKI", "WORKR", "PRNG",
        "SPIN_EQ", "SPIN_NE", "SPIN_EQI", "SPIN_NEI", "SPIN_GE", "ACQ",
        "REL", "HALT", "TSTART", "N_OPS")}
    subs.update(INF=int(_INF), I_LOCAL=I_LOCAL, I_HIT=I_HIT, I_MISS=I_MISS,
                I_XFER=I_XFER, I_ST_OWNED=I_ST_OWNED,
                I_ST_SHARED=I_ST_SHARED, I_INV=I_INV, I_ATOMIC=I_ATOMIC,
                I_WAKE=I_WAKE, N_COSTS=I_WAKE + 1,
                N_BRANCH_KINDS=isa.JMP - isa.BEQ + 1, N_SPIN_KINDS=5,
                N_LAT_BUCKETS=N_LAT_BUCKETS,
                F_PREEMPT=F_PREEMPT, F_SPURIOUS=F_SPURIOUS, F_ABORT=F_ABORT)
    return _C_TEMPLATE % subs


I32P = ctypes.POINTER(ctypes.c_int32)
I64P = ctypes.POINTER(ctypes.c_int64)
_CASES_ARGTYPES = (
    [ctypes.c_int64,                              # n_cases
     I32P, ctypes.c_int32,                        # prog, prog_len
     ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # T, M, L
     I32P, I32P, I32P,                            # init_pc, init_regs, mem
     I32P, I64P,                                  # n_active, seeds
     I32P, I32P, I32P, I32P,                      # wa_base/size, hz, max_ev
     I32P, ctypes.c_int32]                        # costs, mutate flags
    + [I32P] * 4 + [ctypes.c_int32]               # fault arrays + n_faults
    + [I32P] * 9                                  # acq, waited, scalars,
                                                  #   mem, lathist, spin,
                                                  #   pc, regs, ret_codes
    + [I32P, ctypes.c_int64, I32P, ctypes.c_int64]  # trace bufs + caps
    + [I64P, I32P]                                # trace offsets + counts
    + [I32P] * 4                                  # coverage
)


def _compiler() -> str:
    return os.environ.get("CC") or "cc"


def _build_lib():
    src = _c_source()
    # keyed on the host too: the build is tuned with -march=native, and a
    # checkout copied to another machine keeps its build directory
    key = hashlib.sha256((src + platform.node() + platform.machine())
                         .encode()).hexdigest()[:16]
    cache = _build.build_dir() / "fastcase"
    cache.mkdir(parents=True, exist_ok=True)
    so = cache / f"fastcase_{key}.so"
    if not so.exists():
        csrc = cache / f"fastcase_{key}.c"
        csrc.write_text(src)
        cc = _compiler()
        tmp = str(so) + f".{os.getpid()}.tmp"
        args = [cc, "-O3", "-shared", "-fPIC", "-o", tmp, str(csrc)]
        # -march=native when the compiler supports it (the .so is built
        # per machine at first use, so native tuning is always safe)
        if subprocess.run([cc, "-march=native", "-E", "-x", "c", "-",
                           "-o", os.devnull], input=b"",
                          capture_output=True).returncode == 0:
            args.insert(1, "-march=native")
        subprocess.run(args, check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.run_cases.restype = ctypes.c_int
    lib.run_cases.argtypes = _CASES_ARGTYPES
    return lib


_lib: list = []   # [the loaded library or None] once the build was tried


def __getattr__(name):
    """``LIB`` and ``HAVE_FAST``, built on first read.  With no C compiler
    on the host both say so and the batch oracle takes its NumPy path; a
    compiler that fails to build the source, or a library that fails to
    load, raises."""
    if name not in ("LIB", "HAVE_FAST"):
        raise AttributeError(name)
    if not _lib:
        _lib.append(_build_lib() if shutil.which(_compiler()) else None)
    return _lib[0] if name == "LIB" else _lib[0] is not None

__all__ = ["LIB", "HAVE_FAST", "MUTATION_FLAGS", "I32P", "I64P"]
