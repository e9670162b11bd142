// lockVM event loop for one sweep cell, run by one warp.
//
// The device half of csrc/lockvm.cu, kept in a header of its own so that
// the whole event loop reads as one function.  It depends on nothing but
// <stdint.h>, the generated constants header (opcodes, register count,
// cost indices, INF, LINE_SHIFT, N_LAT_BUCKETS, fault kinds: see
// repro_torch/_build.py), these warp primitives: __syncwarp, __shfl_sync,
// __reduce_min_sync, __reduce_add_sync, __any_sync, and __popc, __clz,
// atomicOr and atomicAdd.  So it also compiles on a host that defines them
// (host threads and barriers: csrc/rehearse/), which is how it is checked
// without a card.
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
//
// Layout of the work.  Events form one serial chain per cell (each event's
// selection depends on the last one's effects), and a fig3 sweep leaves one
// warp or fewer on each SM sub-partition, so nothing hides a dependent
// instruction's latency: what the design cuts is the chain of one event.
// Lane u of the warp owns threads u, u + 32, ... ("slots") of the threads
// that can act (lvm_acting_threads): their timelines, pending store, spin
// address, counters and their next instruction, already decoded (opcode,
// operands, address), sit in that lane's registers (LvmRows<TPL>, TPL =
// slots per lane, up to LVM_MAX_TPL = 4, so 128 threads; above that, and
// for a cell in global scratch, the same rows live in the cell's state
// memory, LvmRows<0>).  One event is then:
//   1. every lane takes the first minimum over its own slots, and the warp
//      reduces a packed (time, index) key (lvm_key; two exact reductions
//      when the times do not fit it); while that is in flight, the last
//      actor's lane decodes its next instruction and every lane reads what
//      its candidate's instruction would read of the shared state (memory
//      word, line owner and sharers, lock release time);
//   2. the winning lane owns the event's thread and holds all it needs: it
//      runs the opcode's handler, which makes its own effects (registers of
//      its slot, the shared stores, the thread's program registers);
//   3. the written address and its wake time come over by two shuffles,
//      and every lane wakes its own watchers in registers; one __syncwarp
//      orders the event's shared stores before the next event's loads (and
//      two shuffles after step 1's loads keep them before any store of the
//      event).
// The shared state (memory, sharer bitsets, per-thread program registers,
// lock table, histogram, program) stays in shared memory.
#pragma once

#include <stdint.h>

#define LVM_WARP 32
#define LVM_FULL 0xffffffffu
#define LVM_DEV __device__ __forceinline__
#define LVM_HD __host__ __device__ __forceinline__
// slots per lane kept in registers; a larger T keeps its rows in memory
#define LVM_MAX_TPL 4

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

// Per-thread rows: row r of thread u is rows[r * T + u] in the state
// memory, or a register of u's owner lane.  The last seven hold the
// thread's next instruction decoded (lvm_decode).
enum {
    LR_NEXT_TIME, LR_PC, LR_PRNG, LR_PEND_ADDR, LR_PEND_VAL, LR_PEND_TIME,
    LR_SPIN, LR_WAKE_DELAY, LR_ACQ, LR_WAITED, LR_ACQ_T0,
    LR_OP, LR_C, LR_IMM, LR_RA, LR_RB, LR_RC, LR_ADDR,
    LR_N
};

// Word offsets of one cell's state (shared or global scratch).  A cell's
// state is far below 2^31 words, so offsets inside it are 32-bit (shared
// addresses are); only the total is 64-bit, for the scratch buffer.
struct LvmLayout {
    int mem, sharers, dirty, rows, regs, rel_time, lat, program;
    int64_t total;
};

LVM_HD LvmLayout lvm_layout(int T, int M, int L, int P) {
    const int n_lines = M / WORDS_PER_SECTOR;
    const int n_words = (T + 31) / 32;
    LvmLayout o;
    int at = 0;
    o.mem = at; at += M;
    o.sharers = at; at += n_lines * n_words;
    o.dirty = at; at += n_lines;
    o.rows = at; at += T * LR_N;
    o.regs = at; at += T * N_REGS;
    o.rel_time = at; at += L;
    o.lat = at; at += N_LAT_BUCKETS;
    o.program = at; at += P * 5;
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

// The rows of the slots one lane owns, in registers: slot j is thread
// lane + 32 j.  Every index into v is a constant once the slot loops are
// unrolled; a slot chosen at run time goes through get/put, which select
// among the TPL registers instead of indexing them.
template <int TPL>
struct LvmRows {
    int32_t v[LR_N][TPL];
    LVM_DEV void bind(int32_t *, int, int) {
#pragma unroll
        for (int r = 0; r < LR_N; ++r)
#pragma unroll
            for (int j = 0; j < TPL; ++j) v[r][j] = 0;
    }
    LVM_DEV int32_t &at(int r, int j) { return v[r][j]; }
    LVM_DEV int32_t get(int r, int s) const {
        int32_t x = v[r][0];
#pragma unroll
        for (int j = 1; j < TPL; ++j)
            if (j == s) x = v[r][j];
        return x;
    }
    LVM_DEV void put(int r, int s, int32_t x) {
#pragma unroll
        for (int j = 0; j < TPL; ++j)
            if (j == s) v[r][j] = x;
    }
};

// The same rows in the cell's state memory: past 32 * LVM_MAX_TPL acting
// threads, and for any count when the state lives in global scratch.
template <>
struct LvmRows<0> {
    int32_t *p;
    int T;
    LVM_DEV void bind(int32_t *rows, int lane, int n_threads) {
        p = rows + lane;
        T = n_threads;
    }
    LVM_DEV int32_t &at(int r, int j) { return p[r * T + LVM_WARP * j]; }
    LVM_DEV int32_t get(int r, int s) const {
        return p[r * T + LVM_WARP * s];
    }
    LVM_DEV void put(int r, int s, int32_t x) { at(r, s) = x; }
};

// Every slot of this lane (the loop is unrolled when the rows are
// registers); needs lane, Tn (the threads that can act), nslot and TPL in
// scope.
#define LVM_SLOTS(j)                                                   \
    _Pragma("unroll") for (int j = 0; j < (TPL ? TPL : nslot); ++j)    \
        if (TPL == 0 || lane + LVM_WARP * j < Tn)

// A thread's next instruction as the event needs it.  op packs the opcode
// clamped into the handler table and, from bit 8, the destination register
// plus one (0: the write is dropped); rb holds b itself for STOREI (its
// store value); addr is the memory operand (regs[a] + imm for stores,
// regs[b] + imm otherwise).
struct LvmInsn {
    int32_t op, c, imm, ra, rb, rc, addr;
};

// The instruction at pc decoded against the thread's registers R.
LVM_DEV LvmInsn lvm_decode(int32_t pc, const int32_t *R, const int32_t *prog,
                           int P) {
    const int32_t *I = prog + lvm_gidx(pc, P) * 5;
    const int32_t op = I[0], a = I[1], b = I[2], cc = I[3], imm = I[4];
    const int br = op < 0 ? 0 : (op > LVM_OP_NOEVENT ? LVM_OP_NOEVENT : op);
    const int32_t ra = R[lvm_gidx(a, N_REGS)], rb = R[lvm_gidx(b, N_REGS)];
    const bool store = br == OP_STORE || br == OP_STOREI;
    LvmInsn d;
    d.op = br | ((lvm_sidx(a, N_REGS) + 1) << 8);
    d.c = cc;
    d.imm = imm;
    d.ra = ra;
    d.rb = br == OP_STOREI ? b : rb;
    d.rc = R[lvm_gidx(cc, N_REGS)];
    d.addr = lvm_add(store ? ra : rb, imm);
    return d;
}

template <int TPL>
LVM_DEV void lvm_put_insn(LvmRows<TPL> &rw, int s, const LvmInsn &d) {
    rw.put(LR_OP, s, d.op);
    rw.put(LR_C, s, d.c);
    rw.put(LR_IMM, s, d.imm);
    rw.put(LR_RA, s, d.ra);
    rw.put(LR_RB, s, d.rb);
    rw.put(LR_RC, s, d.rc);
    rw.put(LR_ADDR, s, d.addr);
}


// The shared state an event reads.
struct LvmShared {
    const int32_t *mem, *dirty, *rel_time;
    const uint32_t *sh;
    int M, NL, W, L;
};

// A lane's candidate for the next event: the first minimum over its own
// slots (time, index into [commits | threads], slot), and what its
// instruction would read of the shared state (lvm_operands: the memory
// word, the line's dirty owner and sharer count, whether its thread is a
// sharer, the lock's release time).  The operands are meaningless, and
// unused, for a commit entry; every index is clamped.
struct LvmCand {
    int32_t time;
    int index, slot;
    int32_t memv, dirty, rel, pop;
    bool sharer;
};

template <int TPL>
LVM_DEV LvmCand lvm_candidate(LvmRows<TPL> &rw, int lane, int Tn, int nslot) {
    LvmCand cd;
    cd.time = INT32_MAX;
    cd.index = -1;
    cd.slot = 0;
    LVM_SLOTS(j) {
        const int32_t v = rw.at(LR_PEND_ADDR, j) >= 0
                              ? rw.at(LR_PEND_TIME, j) : INF;
        if (cd.index < 0 || v < cd.time) {
            cd.time = v;
            cd.index = lane + LVM_WARP * j;
            cd.slot = j;
        }
    }
    LVM_SLOTS(j) {
        const int32_t v = rw.at(LR_NEXT_TIME, j);
        if (cd.index < 0 || v < cd.time) {
            cd.time = v;
            cd.index = Tn + lane + LVM_WARP * j;
            cd.slot = j;
        }
    }
    return cd;
}

template <int TPL>
LVM_DEV void lvm_operands(LvmCand &cd, LvmRows<TPL> &rw, const LvmShared &sm,
                          int lane) {
    const int u = lane + LVM_WARP * cd.slot;
    const int32_t addr = rw.get(LR_ADDR, cd.slot);
    const int lng = lvm_gidx(addr >> LINE_SHIFT, sm.NL);
    cd.memv = sm.mem[lvm_gidx(addr, sm.M)];
    cd.dirty = sm.dirty[lng];
    cd.rel = sm.rel_time[lvm_gidx(rw.get(LR_RA, cd.slot), sm.L)];
    const uint32_t *row = sm.sh + lng * sm.W;
    cd.sharer = (row[(u >> 5) < sm.W ? u >> 5 : 0] >> (u & 31)) & 1u;
    cd.pop = 0;
    // a row has at most TPL words when the rows are registers
#pragma unroll
    for (int w = 0; w < (TPL ? TPL : sm.W); w++)
        if (TPL == 0 || w < sm.W) cd.pop += __popc(row[w]);
}

// Earliest event over [commit times | thread times]: the minimum time and
// the FIRST index reaching it (commit half first, then lowest thread).
// Each lane holds its own first minimum (lvm_candidate, in index order: its
// commits, then its threads); the warp takes the minimum time and, among
// lanes holding it, the minimum index.  Usually one reduction does: the
// key (time - base + 1) << ib | index orders entries by time, then index,
// when every time lies in [base, base + 2^(32 - ib) - 3] (base: the last
// event's time; ib: bits of an index).  A time below base makes the
// minimum key 0, none in the window makes it all ones; then two exact
// reductions decide (lvm_resolve: time, then index).
LVM_DEV unsigned lvm_key(const LvmCand &cd, int32_t base, int ib) {
    const uint32_t window = (1u << (32 - ib)) - 3u;
    const uint32_t dd = (uint32_t)lvm_sub(cd.time, base);  // if time >= base
    const bool below = cd.index >= 0 && cd.time < base;
    const bool fits = cd.index >= 0 && cd.time >= base && dd <= window;
    const unsigned key = ((dd + 1u) << ib) | (unsigned)cd.index;
    return fits ? key : (below ? 0u : 0xffffffffu);
}

LVM_DEV void lvm_resolve(unsigned m, const LvmCand &cd, int32_t base, int ib,
                         int32_t *t_min, int *k) {
    if (m != 0u && m != 0xffffffffu) {
        *k = (int)(m & ((1u << ib) - 1u));
        *t_min = lvm_add(base, (int32_t)(m >> ib) - 1);
        return;
    }
    const int32_t mt = __reduce_min_sync(LVM_FULL, cd.time);
    const unsigned cand =
        (cd.index >= 0 && cd.time == mt) ? (unsigned)cd.index : 0xffffffffu;
    *t_min = mt;
    *k = (int)__reduce_min_sync(LVM_FULL, cand);
}

// The threads of a cell that can act: those below n_active (at least one)
// while the horizon is at most INF, else all.  A thread at or past
// n_active starts at INF with nothing pending, and nothing moves it: a
// wake needs it parked, a fault on it only adds to its wake delay or sets
// INF again; so it is selected only if INF is below the horizon.
LVM_HD int lvm_acting_threads(const LvmArgs &g, int cell) {
    const int T = g.n_threads, na = g.n_active[cell];
    if (g.horizon[cell] > INF) return T;
    return na < 1 ? 1 : (na < T ? na : T);
}

// Run one cell from its initial state to the single-cell loop's stop
// condition (events >= max_events, or no event time below the horizon)
// and write its stats.  Called by all LVM_WARP lanes of the cell's warp;
// S points at the cell's state (lvm_layout words).  Tn: the threads that
// can act (lvm_acting_threads); TPL: slots per lane in registers
// (Tn <= 32 * TPL), or 0 for rows in memory.
template <int TPL>
LVM_DEV void lvm_run_cell(const LvmArgs &g, int cell, int lane, int32_t *S,
                          int Tn) {
    const int T = g.n_threads, M = g.mem_words, L = g.n_locks;
    const int P = g.prog_len, F = g.n_faults;
    const int NL = M / WORDS_PER_SECTOR;
    const int W = (T + 31) / 32;
    const int nslot = lane < Tn ? (Tn - 1 - lane) / LVM_WARP + 1 : 0;
    // bits of an index into [commits | threads]
    const int ib = 32 - __clz((unsigned)(2 * Tn - 1));
    const LvmLayout lo = lvm_layout(T, M, L, P);
    int32_t *mem = S + lo.mem;
    uint32_t *sh = (uint32_t *)(S + lo.sharers);
    int32_t *dirty = S + lo.dirty;
    int32_t *regs = S + lo.regs;
    int32_t *rel_time = S + lo.rel_time;
    int32_t *lat = S + lo.lat;
    int32_t *prog = S + lo.program;
    LvmRows<TPL> rw;
    rw.bind(S + lo.rows, lane, T);
    const LvmShared sm = {mem, dirty, rel_time, sh, M, NL, W, L};

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
    LVM_SLOTS(j) {
        const int u = lane + LVM_WARP * j;
        rw.at(LR_NEXT_TIME, j) = u < n_active ? 0 : INF;
        rw.at(LR_PC, j) = g.init_pc[c * T + u];
        rw.at(LR_PRNG, j) = (int32_t)(seed + (uint32_t)u * 2654435761u);
        rw.at(LR_PEND_ADDR, j) = -1;
        rw.at(LR_PEND_VAL, j) = 0;
        rw.at(LR_PEND_TIME, j) = 0;
        rw.at(LR_SPIN, j) = -1;
        rw.at(LR_WAKE_DELAY, j) = 0;
        rw.at(LR_ACQ, j) = 0;
        rw.at(LR_WAITED, j) = 0;
        rw.at(LR_ACQ_T0, j) = -1;
    }
    __syncwarp();  // the program and the registers are in place
    LVM_SLOTS(j) {
        const int u = lane + LVM_WARP * j;
        lvm_put_insn(rw, j, lvm_decode(rw.at(LR_PC, j), regs + u * N_REGS,
                                       prog, P));
    }
    // events counts on every lane; the handover sums on each lane over the
    // events it applied, summed at the end (int32 wrap-around is the same
    // in any order)
    int32_t events = 0, hand_sum = 0, hand_cnt = 0;
    const int last_slot = (T - 1) / LVM_WARP, last_lane = (T - 1) % LVM_WARP;
    int32_t base = 0;  // the last event's time
    // the slot whose thread acted last (on its owner lane; 0 elsewhere)
    int refresh = 0;

    for (;;) {

        // ---- selection: the candidates' times, the reduction, and while
        // it is in flight the last actor's next instruction (its pc and
        // registers changed; on the other lanes a slot decoded again to the
        // same values) and the candidates' operands
        LvmCand cd = lvm_candidate(rw, lane, Tn, nslot);
        unsigned m = __reduce_min_sync(LVM_FULL, lvm_key(cd, base, ib));
        {
            const int u0 = lane + LVM_WARP * refresh;
            const int u = u0 < T ? u0 : T - 1;
            const LvmInsn d = lvm_decode(rw.get(LR_PC, refresh),
                                         regs + u * N_REGS, prog, P);
            // (rows in memory: a lane that owns no thread writes none)
            if (TPL > 0 || refresh < nslot) lvm_put_insn(rw, refresh, d);
        }
        lvm_operands(cd, rw, sm, lane);
        // the pending store of thread T - 1, which an opcode of exactly
        // N_OPS commits (as in the reference), at hand on every lane (a
        // thread that never acts has none).  These shuffles also keep every
        // lane's loads above before any lane's store of this event.
        int32_t last_pa =
            __shfl_sync(LVM_FULL, rw.get(LR_PEND_ADDR, last_slot), last_lane);
        int32_t last_pv =
            __shfl_sync(LVM_FULL, rw.get(LR_PEND_VAL, last_slot), last_lane);
        if (T - 1 >= Tn) {
            last_pa = -1;
            last_pv = 0;
        }
        int32_t t_min;
        int k;
        lvm_resolve(m, cd, base, ib, &t_min, &k);

        // ---- stop check: exactly the reference's single-cell loop condition
        if (!(events < max_events && t_min < horizon)) break;

        // ---- fault phase: entries for this event index mutate the
        // timelines before selection.  Each lane sums every entry aimed at
        // each of its threads (the reference's scatter-add), so duplicate
        // entries behave as they do there.
        if (F) {
            bool any = false;
            for (int fi = lane; fi < F; fi += LVM_WARP)
                any |= fk[fi] != 0 && fe[fi] == events;
            if (__any_sync(LVM_FULL, any)) {
                LVM_SLOTS(j) {
                    const int u = lane + LVM_WARP * j;
                    int32_t k_add = 0;
                    bool spur = false, dead = false;
                    for (int fi = 0; fi < F; fi++) {
                        if (fk[fi] == 0 || fe[fi] != events ||
                            lvm_sidx(ft[fi], T) != u)
                            continue;
                        if (fk[fi] == F_PREEMPT)
                            k_add = lvm_add(k_add, fa[fi]);
                        else if (fk[fi] == F_SPURIOUS) spur = true;
                        else if (fk[fi] == F_ABORT) dead = true;
                    }
                    int32_t nt = rw.at(LR_NEXT_TIME, j);
                    int32_t wd = rw.at(LR_WAKE_DELAY, j);
                    int32_t sp = rw.at(LR_SPIN, j);
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
                    rw.at(LR_NEXT_TIME, j) = nt;
                    rw.at(LR_WAKE_DELAY, j) = wd;
                    rw.at(LR_SPIN, j) = sp;
                }
                cd = lvm_candidate(rw, lane, Tn, nslot);
                m = __reduce_min_sync(LVM_FULL, lvm_key(cd, base, ib));
                lvm_operands(cd, rw, sm, lane);
                __syncwarp();  // these loads before any store of the event
                lvm_resolve(m, cd, base, ib, &t_min, &k);
                // no post-fault event below the horizon: nothing executes
                // and the loop stops on its next check
                if (!(t_min < horizon)) break;
            }
        }

        // ---- the event, on the lane that owns its thread (the winner of
        // the selection: it holds the thread's decoded instruction and what
        // it reads, so nothing crosses lanes until the wake).  Each handler
        // makes its own effects; the reference's apply order holds: the
        // wake of watchers, then the actor's own advance (the actor of a
        // write never sleeps on it), sharer registration before the
        // exclusive grab.
        const bool is_commit = k < Tn;
        const int winner = (is_commit ? k : k - Tn) % LVM_WARP;
        base = t_min;
        refresh = 0;
        int32_t wake_addr = -1, wake_time = 0;
        if (lane == winner) {
            const int slot = cd.slot;
            const int tc = is_commit ? k : T - 1;
            const int t = is_commit ? 0 : k - Tn;
            const int actor = is_commit ? tc : t;
            const int32_t now = t_min;
            const int32_t pc_t = rw.get(LR_PC, slot);
            const int32_t opd = rw.get(LR_OP, slot);
            const int32_t cc = rw.get(LR_C, slot);
            const int32_t imm = rw.get(LR_IMM, slot);
            const int32_t ra = rw.get(LR_RA, slot);
            const int32_t rb = rw.get(LR_RB, slot);
            const int32_t rc = rw.get(LR_RC, slot);
            const int32_t addr = rw.get(LR_ADDR, slot);
            const uint32_t prng_t = (uint32_t)rw.get(LR_PRNG, slot);
            const int br = is_commit ? LVM_OP_COMMIT : (opd & 0xff);
            const int32_t pc1 = lvm_add(pc_t, 1);

            // memory operand and coherence costs
            const int32_t ln = addr >> LINE_SHIFT;
            const bool mine = cd.sharer;
            const int32_t memv = cd.memv, rt = cd.rel;
            const bool foreign = cd.dirty >= 0 && cd.dirty != t;
            const int32_t load_cost =
                mine ? c_hit : (foreign ? c_xfer : c_miss);
            const int32_t others = cd.pop - (mine ? 1 : 0);
            const int32_t store_cost =
                (mine && others == 0)
                    ? c_owned : lvm_add(c_shared, lvm_mul(c_inv, others));
            const int32_t rmw_cost = lvm_add(store_cost, c_atomic);
            const uint32_t a_bit = 1u << (actor & 31);
            const int a_word = actor >> 5;

            // a read (LOAD, SPIN) registers the actor as a sharer of its
            // line (an atomic whose result is not waited for)
            auto share = [&]() {
                if (ln >= 0 && ln < NL) atomicOr(sh + ln * W + a_word, a_bit);
            };
            // a write (an atomic, a commit) updates memory, takes the line
            // exclusive and wakes the line's watchers at wt
            auto write = [&](int32_t wa, int32_t wv, int32_t wt) {
                if (wa >= 0 && wa < M) mem[wa] = wv;
                const int32_t xl = wa >> LINE_SHIFT;
                if (xl >= 0 && xl < NL) {
#pragma unroll
                    for (int w = 0; w < (TPL ? TPL : W); w++)
                        if (TPL == 0 || w < W)
                            sh[xl * W + w] = w == a_word ? a_bit : 0u;
                    dirty[xl] = actor;
                }
                wake_addr = wa;
                wake_time = wt;
            };

            int32_t cost = c_local, new_pc = pc1;
            bool adv = true, sleep = false, reg_write = false;
            int32_t reg_val = 0;
            uint32_t prng_new = prng_t;
            switch (br) {
            case OP_NOP:
                break;
            case OP_LOAD:
                cost = load_cost;
                reg_write = true;
                reg_val = memv;
                share();
                if (!mine && foreign && ln >= 0 && ln < NL) dirty[ln] = -1;
                break;
            case OP_STORE:
            case OP_STOREI:
                // rb holds b itself for STOREI (lvm_decode)
                cost = store_cost;
                if (addr >= 0) {
                    rw.put(LR_PEND_ADDR, slot, addr);
                    rw.put(LR_PEND_VAL, slot, rb);
                    rw.put(LR_PEND_TIME, slot, lvm_add(now, store_cost));
                }
                break;
            case OP_FADD:
            case OP_SWAP:
            case OP_CASZ:
                cost = rmw_cost;
                reg_write = true;
                reg_val = memv;
                write(addr,
                      br == OP_FADD ? lvm_add(memv, cc)
                      : br == OP_SWAP ? rc : (memv == rc ? 0 : memv),
                      lvm_add(now, rmw_cost));
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
                const uint32_t sd = prng_t * 1664525u + 1013904223u;
                reg_write = true;
                reg_val = (int32_t)(sd >> 16) % (imm > 1 ? imm : 1);
                prng_new = sd;
                break;
            }
            case OP_SPIN_EQ:
            case OP_SPIN_NE:
            case OP_SPIN_EQI:
            case OP_SPIN_NEI:
            case OP_SPIN_GE: {
                const bool proceed =
                    br == OP_SPIN_EQ    ? memv == ra
                    : br == OP_SPIN_NE  ? memv != ra
                    : br == OP_SPIN_EQI ? memv == cc
                    : br == OP_SPIN_NEI ? memv != cc
                                        : lvm_sub(memv, ra) >= 0;
                cost = load_cost;
                share();
                if (!proceed) {  // park on the address (none if negative)
                    sleep = true;
                    new_pc = pc_t;
                    if (addr >= 0) rw.put(LR_SPIN, slot, addr);
                }
                break;
            }
            case OP_ACQ: {
                const bool got = cc > 0 && rt >= 0;
                const int32_t t0v = rw.get(LR_ACQ_T0, slot);
                rw.put(LR_ACQ, slot, lvm_add(rw.get(LR_ACQ, slot), 1));
                if (cc > 0)
                    rw.put(LR_WAITED, slot,
                           lvm_add(rw.get(LR_WAITED, slot), 1));
                if (got) {
                    hand_sum = lvm_add(hand_sum, lvm_sub(now, rt));
                    hand_cnt = lvm_add(hand_cnt, 1);
                }
                if (ra >= 0 && ra < L) rel_time[ra] = got ? -1 : rt;
                if (t0v >= 0) {  // the acquisition latency since TSTART
                    int32_t blat = lvm_sub(now, t0v);
                    if (blat < 0) blat = 0;
                    atomicAdd(lat + lvm_bucket(blat), 1);
                    rw.put(LR_ACQ_T0, slot, -1);
                }
                break;
            }
            case OP_TSTART: rw.put(LR_ACQ_T0, slot, now); break;
            case OP_REL: if (rb >= 0 && rb < L) rel_time[rb] = now; break;
            case OP_HALT: cost = INF; new_pc = pc_t; break;
            case LVM_OP_COMMIT:
                // the selected thread's pending store becomes visible (an
                // opcode of exactly N_OPS reaches this handler too, as in
                // the reference, with tc = T - 1)
                adv = false;
                write(is_commit ? rw.get(LR_PEND_ADDR, slot) : last_pa,
                      is_commit ? rw.get(LR_PEND_VAL, slot) : last_pv, now);
                rw.put(LR_PEND_ADDR, slot, -1);
                break;
            default:  // LVM_OP_NOEVENT
                adv = false;
                break;
            }

            // wake this lane's watchers (the other lanes wake theirs below)
            if (wake_addr >= 0) {
                const int32_t resume = lvm_add(wake_time, c_wake);
                LVM_SLOTS(j) {
                    if (rw.at(LR_SPIN, j) == wake_addr) {
                        rw.at(LR_NEXT_TIME, j) =
                            lvm_add(resume, rw.at(LR_WAKE_DELAY, j));
                        rw.at(LR_WAKE_DELAY, j) = 0;
                        rw.at(LR_SPIN, j) = -1;
                    }
                }
            }
            // then the actor's own advance (its next instruction is
            // decoded during the next selection)
            if (adv) {
                rw.put(LR_NEXT_TIME, slot, sleep ? INF : lvm_add(now, cost));
                rw.put(LR_PC, slot, new_pc);
                rw.put(LR_PRNG, slot, (int32_t)prng_new);
                const int dst = (opd >> 8) - 1;
                if (reg_write && dst >= 0)
                    regs[actor * N_REGS + dst] = reg_val;
            }
            refresh = slot;
        }
        // ---- the other lanes wake their watchers of the written address;
        // a woken thread pays its preemption debt on top of C_WAKE
        wake_addr = __shfl_sync(LVM_FULL, wake_addr, winner);
        wake_time = __shfl_sync(LVM_FULL, wake_time, winner);
        if (wake_addr >= 0 && lane != winner) {
            const int32_t resume = lvm_add(wake_time, c_wake);
            LVM_SLOTS(j) {
                if (rw.at(LR_SPIN, j) == wake_addr) {
                    rw.at(LR_NEXT_TIME, j) =
                        lvm_add(resume, rw.at(LR_WAKE_DELAY, j));
                    rw.at(LR_WAKE_DELAY, j) = 0;
                    rw.at(LR_SPIN, j) = -1;
                }
            }
        }
        events += 1;
        __syncwarp();  // this event's shared stores before the next's loads
    }

    // ---- stats
    __syncwarp();
    int sleeping = 0;
    LVM_SLOTS(j) {
        const int u = lane + LVM_WARP * j;
        g.out_acq[c * T + u] = rw.at(LR_ACQ, j);
        g.out_waited[c * T + u] = rw.at(LR_WAITED, j);
        sleeping += rw.at(LR_SPIN, j) >= 0;
    }
    for (int u = Tn + lane; u < T; u += LVM_WARP) {  // never acted
        g.out_acq[c * T + u] = 0;
        g.out_waited[c * T + u] = 0;
    }
    sleeping = (int)__reduce_add_sync(LVM_FULL, (unsigned)sleeping);
    hand_sum = (int32_t)__reduce_add_sync(LVM_FULL, (unsigned)hand_sum);
    hand_cnt = (int32_t)__reduce_add_sync(LVM_FULL, (unsigned)hand_cnt);
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
