// lockVM event loop for one sweep cell, run by one warp.
//
// The device half of csrc/lockvm.cu, kept in a header of its own so that
// the whole event loop reads as one function.  It depends on nothing but
// <stdint.h>, the generated constants header (opcodes, register count,
// cost indices, INF, LINE_SHIFT, N_LAT_BUCKETS, fault kinds: see
// repro_torch/_build.py) and these warp primitives: __syncwarp,
// __reduce_min_sync, __reduce_add_sync, __any_sync, __popc, __clz.
//
// The transition is the reference engine's (repro/sim/engine.py:_step) and
// the plain PyTorch engine's (repro_torch/sim/engine.py:_step), bit for bit:
//   * int32 arithmetic wraps: every add, sub and mul goes through uint32
//     (signed overflow is undefined in C++);
//   * indices taken from program data follow JAX's rules: a gather wraps a
//     negative index once and then clamps (lvm_gidx); a scatter wraps once
//     and then drops the write (lvm_sidx); an opcode outside the ISA is
//     clamped into the handler table as lax.switch clamps its index;
//   * event selection is one argmin over [pending-commit times | thread
//     times] with the first minimum winning, written out explicitly;
//   * the apply order is the reference's: wake watchers, then the actor's
//     own park/advance (which wins over a wake); sharer registration
//     before the exclusive grab; faults gated on the pre-fault liveness.
#pragma once

#include <stdint.h>

#ifndef LVM_WARP
#define LVM_WARP 32
#endif
#define LVM_FULL 0xffffffffu
#define LVM_DEV __device__ __forceinline__
#define LVM_HD __host__ __device__ __forceinline__

#define LVM_OP_COMMIT N_OPS
#define LVM_OP_NOEVENT (N_OPS + 1)

struct LvmArgs {
    // inputs, batched over cells: (B, P, 5), (B, T), (B, T, N_REGS), (B, M),
    // then (B,) scalars and (B, N_COSTS) costs
    const int32_t *program, *init_pc, *init_regs, *init_mem;
    const int32_t *n_active, *seed, *horizon, *max_events, *costs;
    const int32_t *wa_base, *wa_mask, *wa_size;
    // fault schedule (B, F) each, or null when F == 0
    const int32_t *f_kind, *f_evt, *f_tid, *f_arg;
    // outputs: (B, T) x2, (B,) x4, (B, M), (B, N_LAT_BUCKETS)
    int32_t *out_acq, *out_waited, *out_hand_sum, *out_hand_cnt;
    int32_t *out_events, *out_sleeping, *out_mem, *out_lat;
    int32_t n_cells, n_threads, mem_words, n_locks, prog_len, n_faults;
    // per-cell state in global memory (state_words each), or null when the
    // state lives in dynamic shared memory
    int32_t *scratch;
    int64_t state_words;
};

// Word offsets of one cell's state (shared or global scratch).
struct LvmLayout {
    int64_t mem, sharers, dirty, next_time, pc, prng, pend_addr, pend_val,
        pend_time, spin, wake_delay, acq, waited, acq_t0, regs, rel_time,
        lat, program, total;
};

LVM_HD LvmLayout lvm_layout(int T, int M, int L, int P) {
    const int64_t n_lines = M / WORDS_PER_SECTOR;
    const int64_t n_words = (T + 31) / 32;
    LvmLayout o;
    int64_t at = 0;
    o.mem = at; at += M;
    o.sharers = at; at += n_lines * n_words;
    o.dirty = at; at += n_lines;
    o.next_time = at; at += T;
    o.pc = at; at += T;
    o.prng = at; at += T;
    o.pend_addr = at; at += T;
    o.pend_val = at; at += T;
    o.pend_time = at; at += T;
    o.spin = at; at += T;
    o.wake_delay = at; at += T;
    o.acq = at; at += T;
    o.waited = at; at += T;
    o.acq_t0 = at; at += T;
    o.regs = at; at += (int64_t)T * N_REGS;
    o.rel_time = at; at += L;
    o.lat = at; at += N_LAT_BUCKETS;
    o.program = at; at += (int64_t)P * 5;
    o.total = at;
    return o;
}

LVM_DEV int32_t lvm_add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
LVM_DEV int32_t lvm_sub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}
LVM_DEV int32_t lvm_mul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
}

// JAX gather index: wrap a negative index once, then clamp to [0, n).
LVM_DEV int lvm_gidx(int32_t i, int n) {
    if (i < 0) i += n;
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// JAX scatter index: wrap once; -1 = the write is dropped.
LVM_DEV int lvm_sidx(int32_t i, int n) {
    if (i < 0) i += n;
    return (i >= 0 && i < n) ? i : -1;
}

// log2 acquire-latency bucket: the number of k in 0..30 with lat >= 2^k.
LVM_DEV int lvm_bucket(int32_t lat) {
    return lat > 0 ? 32 - __clz((uint32_t)lat) : 0;
}

// Earliest event over [commit times | thread times]: the minimum time and
// the FIRST index reaching it (commit half first, then lowest thread).
// Each lane scans a strided slice in increasing index order keeping its
// first minimum; the warp then takes the minimum time and, among lanes
// holding it, the minimum index.
LVM_DEV void lvm_select(int T, int lane, const int32_t *pend_addr,
                        const int32_t *pend_time, const int32_t *next_time,
                        int32_t *t_min, int *k) {
    int32_t best = INT32_MAX;
    int best_k = -1;
    for (int i = lane; i < 2 * T; i += LVM_WARP) {
        int32_t v = i < T ? (pend_addr[i] >= 0 ? pend_time[i] : INF)
                          : next_time[i - T];
        if (best_k < 0 || v < best) {
            best = v;
            best_k = i;
        }
    }
    int32_t m = __reduce_min_sync(LVM_FULL, best);
    unsigned cand = (best_k >= 0 && best == m) ? (unsigned)best_k : 0xffffffffu;
    *t_min = m;
    *k = (int)__reduce_min_sync(LVM_FULL, cand);
}

// Run one cell from its initial state to the single-cell loop's stop
// condition (events >= max_events, or no event time below the horizon)
// and write its stats.  Called by all LVM_WARP lanes of the cell's warp;
// S points at the cell's state (lvm_layout words).
LVM_DEV void lvm_run_cell(const LvmArgs &g, int cell, int lane, int32_t *S) {
    const int T = g.n_threads, M = g.mem_words, L = g.n_locks;
    const int P = g.prog_len, F = g.n_faults;
    const int NL = M / WORDS_PER_SECTOR;
    const int W = (T + 31) / 32;
    const LvmLayout lo = lvm_layout(T, M, L, P);
    int32_t *mem = S + lo.mem;
    uint32_t *sh = (uint32_t *)(S + lo.sharers);
    int32_t *dirty = S + lo.dirty;
    int32_t *next_time = S + lo.next_time;
    int32_t *pc = S + lo.pc;
    uint32_t *prng = (uint32_t *)(S + lo.prng);
    int32_t *pend_addr = S + lo.pend_addr;
    int32_t *pend_val = S + lo.pend_val;
    int32_t *pend_time = S + lo.pend_time;
    int32_t *spin = S + lo.spin;
    int32_t *wake_delay = S + lo.wake_delay;
    int32_t *acq = S + lo.acq;
    int32_t *waited = S + lo.waited;
    int32_t *acq_t0 = S + lo.acq_t0;
    int32_t *regs = S + lo.regs;
    int32_t *rel_time = S + lo.rel_time;
    int32_t *lat = S + lo.lat;
    int32_t *prog = S + lo.program;

    const int64_t c = cell;
    const int32_t *C = g.costs + c * N_COSTS;
    const int32_t c_local = C[I_LOCAL], c_hit = C[I_HIT], c_miss = C[I_MISS];
    const int32_t c_xfer = C[I_XFER], c_owned = C[I_ST_OWNED];
    const int32_t c_shared = C[I_ST_SHARED], c_inv = C[I_INV];
    const int32_t c_atomic = C[I_ATOMIC], c_wake = C[I_WAKE];
    const int32_t horizon = g.horizon[c], max_events = g.max_events[c];
    const int32_t wa_base = g.wa_base[c], wa_mask = g.wa_mask[c];
    const int32_t wa_size = g.wa_size[c], n_active = g.n_active[c];
    const uint32_t seed = (uint32_t)g.seed[c];
    const int32_t *fk = F ? g.f_kind + c * F : 0;
    const int32_t *fe = F ? g.f_evt + c * F : 0;
    const int32_t *ft = F ? g.f_tid + c * F : 0;
    const int32_t *fa = F ? g.f_arg + c * F : 0;

    // ---- initial state
    for (int i = lane; i < M; i += LVM_WARP) mem[i] = g.init_mem[c * M + i];
    for (int i = lane; i < P * 5; i += LVM_WARP)
        prog[i] = g.program[c * P * 5 + i];
    for (int i = lane; i < NL * W; i += LVM_WARP) sh[i] = 0u;
    for (int i = lane; i < NL; i += LVM_WARP) dirty[i] = -1;
    for (int i = lane; i < T * N_REGS; i += LVM_WARP)
        regs[i] = g.init_regs[c * T * N_REGS + i];
    for (int i = lane; i < L; i += LVM_WARP) rel_time[i] = -1;
    for (int i = lane; i < N_LAT_BUCKETS; i += LVM_WARP) lat[i] = 0;
    for (int u = lane; u < T; u += LVM_WARP) {
        next_time[u] = u < n_active ? 0 : INF;
        pc[u] = g.init_pc[c * T + u];
        prng[u] = seed + (uint32_t)u * 2654435761u;
        pend_addr[u] = -1;
        pend_val[u] = 0;
        pend_time[u] = 0;
        spin[u] = -1;
        wake_delay[u] = 0;
        acq[u] = 0;
        waited[u] = 0;
        acq_t0[u] = -1;
    }
    int32_t events = 0, hand_sum = 0, hand_cnt = 0;
    __syncwarp();

    for (;;) {
        // ---- stop check: exactly the reference's single-cell loop condition
        int32_t t_min;
        int k;
        lvm_select(T, lane, pend_addr, pend_time, next_time, &t_min, &k);
        if (!(events < max_events && t_min < horizon)) break;
        __syncwarp();

        // ---- fault phase: entries for this event index mutate the
        // timelines before selection.  Each lane owns a strided set of
        // threads and sums every entry aimed at them (the reference's
        // scatter-add), so duplicate entries behave as they do there.
        if (F) {
            bool any = false;
            for (int f = lane; f < F; f += LVM_WARP)
                any |= fk[f] != 0 && fe[f] == events;
            if (__any_sync(LVM_FULL, any)) {
                for (int u = lane; u < T; u += LVM_WARP) {
                    int32_t k_add = 0;
                    bool spur = false, dead = false;
                    for (int f = 0; f < F; f++) {
                        if (fk[f] == 0 || fe[f] != events ||
                            lvm_sidx(ft[f], T) != u)
                            continue;
                        if (fk[f] == F_PREEMPT) k_add = lvm_add(k_add, fa[f]);
                        else if (fk[f] == F_SPURIOUS) spur = true;
                        else if (fk[f] == F_ABORT) dead = true;
                    }
                    int32_t nt = next_time[u], wd = wake_delay[u];
                    int32_t sp = spin[u];
                    if (nt < INF) nt = lvm_add(nt, k_add);
                    else wd = lvm_add(wd, k_add);
                    if (spur && sp >= 0) {
                        nt = lvm_add(lvm_add(t_min, c_wake), wd);
                        wd = 0;
                        sp = -1;
                    }
                    if (dead) {
                        nt = INF;
                        sp = -1;
                    }
                    next_time[u] = nt;
                    wake_delay[u] = wd;
                    spin[u] = sp;
                }
                __syncwarp();
                lvm_select(T, lane, pend_addr, pend_time, next_time, &t_min,
                           &k);
                // no post-fault event below the horizon: nothing executes
                // and the loop stops on its next check
                if (!(t_min < horizon)) break;
                __syncwarp();
            }
        }

        // ---- decode: every lane evaluates the same event (warp-uniform)
        const bool is_commit = k < T;
        const int tc = is_commit ? k : T - 1;
        const int t = is_commit ? 0 : k - T;
        const int32_t now = t_min;
        const int32_t pc_t = pc[t];
        const int32_t *I = prog + lvm_gidx(pc_t, P) * 5;
        const int32_t op = I[0], a = I[1], b = I[2], cc = I[3], imm = I[4];
        const int32_t *R = regs + t * N_REGS;
        const int32_t ra = R[lvm_gidx(a, N_REGS)], rb = R[lvm_gidx(b, N_REGS)];
        const int32_t rc = R[lvm_gidx(cc, N_REGS)];
        const int32_t pc1 = lvm_add(pc_t, 1);
        const int br = is_commit ? LVM_OP_COMMIT
                                 : (op < 0 ? 0
                                           : (op > LVM_OP_NOEVENT ? LVM_OP_NOEVENT
                                                                  : op));

        // memory operand and coherence costs (sharer row popcount across
        // the warp: lane w counts word w)
        const int32_t addr =
            lvm_add((br == OP_STORE || br == OP_STOREI) ? ra : rb, imm);
        const int32_t ln = addr >> LINE_SHIFT;
        const int lng = lvm_gidx(ln, NL);
        const uint32_t t_bit = 1u << (t & 31);
        const bool mine = (sh[lng * W + (t >> 5)] & t_bit) != 0;
        const int32_t d = dirty[lng];
        const bool foreign = d >= 0 && d != t;
        const int32_t load_cost = mine ? c_hit : (foreign ? c_xfer : c_miss);
        int pop = 0;
        for (int w = lane; w < W; w += LVM_WARP) pop += __popc(sh[lng * W + w]);
        const int32_t others = (int32_t)__reduce_add_sync(LVM_FULL, (unsigned)pop)
                               - (mine ? 1 : 0);
        const int32_t store_cost = (mine && others == 0)
                                       ? c_owned
                                       : lvm_add(c_shared, lvm_mul(c_inv, others));
        const int32_t rmw_cost = lvm_add(store_cost, c_atomic);
        const int32_t memv = mem[lvm_gidx(addr, M)];

        // ---- effects (defaults = the reference's default Effects)
        int32_t cost = c_local, new_pc = pc1;
        bool reg_write = false;
        int32_t reg_val = 0;
        uint32_t prng_new = prng[t];
        bool sleep = false, adv = true;
        int32_t st_addr = -1, st_val = 0, st_time = 0;
        bool clear_pend = false;
        int32_t w_addr = -1, w_val = 0, excl_ln = -1, share_ln = -1;
        bool downgrade = false;
        int32_t park = -1, wake_addr = -1, wake_time = 0;
        bool acq_inc = false, waited_inc = false, hand_inc = false;
        int32_t hand_add = 0, rel_idx = -1, rel_val = 0, t0_new = -2;
        int32_t lat_idx = -1;
        bool proceed = true;

        switch (br) {
        case OP_NOP:
            break;
        case OP_LOAD:
            cost = load_cost;
            reg_write = true;
            reg_val = memv;
            share_ln = ln;
            downgrade = !mine && foreign;
            break;
        case OP_STORE:
        case OP_STOREI:
            cost = store_cost;
            st_addr = addr;
            st_val = br == OP_STORE ? rb : b;
            st_time = lvm_add(now, store_cost);
            break;
        case OP_FADD:
        case OP_SWAP:
        case OP_CASZ:
            cost = rmw_cost;
            reg_write = true;
            reg_val = memv;
            w_addr = addr;
            w_val = br == OP_FADD ? lvm_add(memv, cc)
                    : br == OP_SWAP ? rc
                                    : (memv == rc ? 0 : memv);
            excl_ln = ln;
            wake_addr = addr;
            wake_time = lvm_add(now, rmw_cost);
            break;
        case OP_ADDI: reg_write = true; reg_val = lvm_add(rb, imm); break;
        case OP_MOVI: reg_write = true; reg_val = imm; break;
        case OP_MOV: reg_write = true; reg_val = rb; break;
        case OP_SUB: reg_write = true; reg_val = lvm_sub(rb, rc); break;
        case OP_MULI: reg_write = true; reg_val = lvm_mul(rb, imm); break;
        case OP_ANDI: reg_write = true; reg_val = rb & imm; break;
        case OP_HASH:
            reg_write = true;
            reg_val = lvm_add(wa_base, (lvm_mul(rb, 127) ^ rc) & wa_mask);
            break;
        case OP_HASHP:
            reg_write = true;
            reg_val = lvm_add(lvm_add(wa_base, lvm_mul(rc, wa_size)),
                              lvm_mul(rb, 127) & wa_mask);
            break;
        case OP_BEQ: if (ra == rb) new_pc = imm; break;
        case OP_BNE: if (ra != rb) new_pc = imm; break;
        case OP_BLE: if (ra <= rb) new_pc = imm; break;
        case OP_BGT: if (ra > rb) new_pc = imm; break;
        case OP_BEQI: if (ra == cc) new_pc = imm; break;
        case OP_BNEI: if (ra != cc) new_pc = imm; break;
        case OP_BLEI: if (ra <= cc) new_pc = imm; break;
        case OP_BGTI: if (ra > cc) new_pc = imm; break;
        case OP_JMP: new_pc = imm; break;
        case OP_WORKI: cost = imm > 1 ? imm : 1; break;
        case OP_WORKR: cost = ra > 1 ? ra : 1; break;
        case OP_PRNG: {
            const uint32_t sd = prng[t] * 1664525u + 1013904223u;
            reg_write = true;
            reg_val = (int32_t)(sd >> 16) % (imm > 1 ? imm : 1);
            prng_new = sd;
            break;
        }
        case OP_SPIN_EQ:
        case OP_SPIN_NE:
        case OP_SPIN_EQI:
        case OP_SPIN_NEI:
        case OP_SPIN_GE:
            proceed = br == OP_SPIN_EQ    ? memv == ra
                      : br == OP_SPIN_NE  ? memv != ra
                      : br == OP_SPIN_EQI ? memv == cc
                      : br == OP_SPIN_NEI ? memv != cc
                                          : lvm_sub(memv, ra) >= 0;
            cost = load_cost;
            new_pc = proceed ? pc1 : pc_t;
            share_ln = ln;
            sleep = !proceed;
            park = proceed ? -1 : addr;
            break;
        case OP_ACQ: {
            const int32_t rt = rel_time[lvm_gidx(ra, L)];
            const bool got = cc > 0 && rt >= 0;
            const int32_t t0v = acq_t0[t];
            const bool marked = t0v >= 0;
            int32_t blat = lvm_sub(now, t0v);
            if (blat < 0) blat = 0;
            acq_inc = true;
            waited_inc = cc > 0;
            hand_add = got ? lvm_sub(now, rt) : 0;
            hand_inc = got;
            rel_idx = ra;
            rel_val = got ? -1 : rt;
            lat_idx = marked ? lvm_bucket(blat) : -1;
            t0_new = marked ? -1 : -2;
            break;
        }
        case OP_TSTART: t0_new = now; break;
        case OP_REL: rel_idx = rb; rel_val = now; break;
        case OP_HALT: cost = INF; new_pc = pc_t; break;
        case LVM_OP_COMMIT:
            // the selected thread's pending store becomes visible (an
            // opcode of exactly N_OPS reaches this handler too, as in the
            // reference, with tc = T - 1)
            adv = false;
            clear_pend = true;
            w_addr = pend_addr[tc];
            w_val = pend_val[tc];
            excl_ln = w_addr >> LINE_SHIFT;
            wake_addr = w_addr;
            wake_time = now;
            break;
        default:  // LVM_OP_NOEVENT
            adv = false;
            break;
        }
        __syncwarp();  // every lane has read what the event depends on

        // ---- apply: wake watchers of the written address (lane-parallel);
        // a woken thread pays its preemption debt on top of C_WAKE
        if (wake_addr >= 0) {
            const int32_t resume = lvm_add(wake_time, c_wake);
            for (int u = lane; u < T; u += LVM_WARP)
                if (spin[u] == wake_addr) {
                    next_time[u] = lvm_add(resume, wake_delay[u]);
                    wake_delay[u] = 0;
                    spin[u] = -1;
                }
        }
        __syncwarp();
        if (lane == 0) {
            const int actor = is_commit ? tc : t;
            if (park >= 0) spin[actor] = park;
            if (adv) {
                next_time[actor] = sleep ? INF : lvm_add(now, cost);
                pc[actor] = new_pc;
                const int dst = lvm_sidx(a, N_REGS);
                if (reg_write && dst >= 0) regs[actor * N_REGS + dst] = reg_val;
                prng[actor] = prng_new;
            }
            if (w_addr >= 0 && w_addr < M) mem[w_addr] = w_val;
            const uint32_t a_bit = 1u << (actor & 31);
            const int a_word = actor >> 5;
            if (share_ln >= 0 && share_ln < NL) {
                sh[share_ln * W + a_word] |= a_bit;
                if (downgrade) dirty[share_ln] = -1;
            }
            if (excl_ln >= 0 && excl_ln < NL) {
                for (int w = 0; w < W; w++)
                    sh[excl_ln * W + w] = w == a_word ? a_bit : 0u;
                dirty[excl_ln] = actor;
            }
            if (st_addr >= 0) {
                pend_addr[actor] = st_addr;
                pend_val[actor] = st_val;
                pend_time[actor] = st_time;
            } else if (clear_pend) {
                pend_addr[actor] = -1;
            }
            if (acq_inc) acq[actor] = lvm_add(acq[actor], 1);
            if (waited_inc) waited[actor] = lvm_add(waited[actor], 1);
            if (rel_idx >= 0 && rel_idx < L) rel_time[rel_idx] = rel_val;
            if (t0_new != -2) acq_t0[actor] = t0_new;
            if (lat_idx >= 0) lat[lat_idx] += 1;
        }
        hand_sum = lvm_add(hand_sum, hand_add);
        hand_cnt = lvm_add(hand_cnt, hand_inc ? 1 : 0);
        events += 1;
        __syncwarp();
    }

    // ---- stats
    __syncwarp();
    int sleeping = 0;
    for (int u = lane; u < T; u += LVM_WARP) {
        g.out_acq[c * T + u] = acq[u];
        g.out_waited[c * T + u] = waited[u];
        sleeping += spin[u] >= 0;
    }
    sleeping = (int)__reduce_add_sync(LVM_FULL, (unsigned)sleeping);
    for (int i = lane; i < M; i += LVM_WARP) g.out_mem[c * M + i] = mem[i];
    for (int i = lane; i < N_LAT_BUCKETS; i += LVM_WARP)
        g.out_lat[c * N_LAT_BUCKETS + i] = lat[i];
    if (lane == 0) {
        g.out_hand_sum[c] = hand_sum;
        g.out_hand_cnt[c] = hand_cnt;
        g.out_events[c] = events;
        g.out_sleeping[c] = sleeping;
    }
}
