// Host rehearsal of the lockVM kernel's device code (lockvm_step.cuh): the
// same lvm_run_cell that lockvm.cu launches, each cell's warp run as 32
// host threads (warp_emu.h), each cell's state in a host buffer as the
// kernel's global-scratch path keeps it.
//
//   lockvm_host IN OUT [TPL]
//
// IN holds int32 words: n_cells, n_threads, mem_words, n_locks, prog_len,
// n_faults, then the arrays of engine_cuda.run_cells in its order (program,
// init_pc, init_regs, init_mem, n_active, seed, horizon, max_events, costs,
// wa_base, wa_mask, wa_size, and with faults f_kind, f_evt, f_tid, f_arg).
// OUT receives the outputs in OUT_KEYS order (acquisitions,
// waited_acquisitions, handover_sum, handover_count, events, sleeping,
// grant_value, lat_hist).  TPL forces the rows' variant of every cell (1, 2
// or 4 slots a lane in registers, 0 in memory, as a cell in global scratch
// keeps them); by default each cell's is chosen from its acting threads as
// lockvm.cu chooses it for a cell in shared memory.  Built by
// repro_torch/rehearse.py with the generated constants header.
#include "warp_emu.h"

#include "lockvm_step.cuh"

template <int TPL>
static void run_cell(const LvmArgs &g, std::vector<int32_t> &state, int cell,
                     int Tn) {
    emu_block(LVM_WARP, [&](int lane) {
        lvm_run_cell<TPL>(g, cell, lane,
                          state.data() + (int64_t)cell * g.state_words, Tn);
    });
}

int main(int argc, char **argv) {
    if (argc < 3) {
        std::fprintf(stderr, "usage: %s IN OUT [TPL]\n", argv[0]);
        return 2;
    }
    std::vector<uint32_t> in = emu_read(argv[1]);
    const int32_t *w = (const int32_t *)in.data();
    const int B = w[0], T = w[1], M = w[2], L = w[3], P = w[4], F = w[5];
    size_t at = 6;
    auto take = [&](int64_t n) {
        const int32_t *p = w + at;
        at += n;
        return p;
    };
    LvmArgs g{};
    g.program = take((int64_t)B * P * 5);
    g.init_pc = take((int64_t)B * T);
    g.init_regs = take((int64_t)B * T * N_REGS);
    g.init_mem = take((int64_t)B * M);
    g.n_active = take(B);
    g.seed = take(B);
    g.horizon = take(B);
    g.max_events = take(B);
    g.costs = take((int64_t)B * N_COSTS);
    g.wa_base = take(B);
    g.wa_mask = take(B);
    g.wa_size = take(B);
    if (F) {
        g.f_kind = take((int64_t)B * F);
        g.f_evt = take((int64_t)B * F);
        g.f_tid = take((int64_t)B * F);
        g.f_arg = take((int64_t)B * F);
    }
    if (at != in.size()) {
        std::fprintf(stderr, "lockvm_host: %zu words read, %zu given\n", at,
                     in.size());
        return 2;
    }
    std::vector<int32_t> acq((size_t)B * T), waited((size_t)B * T),
        hand_sum(B), hand_cnt(B), events(B), sleeping(B),
        mem_out((size_t)B * M), lat((size_t)B * N_LAT_BUCKETS);
    g.out_acq = acq.data();
    g.out_waited = waited.data();
    g.out_hand_sum = hand_sum.data();
    g.out_hand_cnt = hand_cnt.data();
    g.out_events = events.data();
    g.out_sleeping = sleeping.data();
    g.out_mem = mem_out.data();
    g.out_lat = lat.data();
    g.n_cells = B;
    g.n_threads = T;
    g.mem_words = M;
    g.n_locks = L;
    g.prog_len = P;
    g.n_faults = F;
    g.state_words = lvm_layout(T, M, L, P).total;
    std::vector<int32_t> state((size_t)B * g.state_words, 0x5a5a5a5a);
    g.scratch = state.data();

    // the rows' variant of each cell: forced, or as lockvm.cu chooses it
    // for a cell in shared memory
    const int forced = argc > 3 ? std::atoi(argv[3]) : -1;
    if (forced != -1 && forced != 0 && forced != 1 && forced != 2 &&
        forced != 4) {
        std::fprintf(stderr, "lockvm_host: no rows' variant %d\n", forced);
        return 2;
    }
    for (int cell = 0; cell < B; ++cell) {
        const int Tn = lvm_acting_threads(g, cell);
        const int tpl = forced >= 0 ? forced
                        : Tn <= 32 ? 1 : Tn <= 64 ? 2 : Tn <= 128 ? 4 : 0;
        if (tpl > 0 && Tn > 32 * tpl) {
            std::fprintf(stderr, "lockvm_host: %d threads a lane cannot "
                         "hold %d\n", tpl, Tn);
            return 2;
        }
        switch (tpl) {
        case 1: run_cell<1>(g, state, cell, Tn); break;
        case 2: run_cell<2>(g, state, cell, Tn); break;
        case 4: run_cell<4>(g, state, cell, Tn); break;
        default: run_cell<0>(g, state, cell, Tn); break;
        }
    }
    std::vector<uint32_t> out;
    for (const auto *v : {&acq, &waited, &hand_sum, &hand_cnt, &events,
                          &sleeping, &mem_out, &lat})
        out.insert(out.end(), v->begin(), v->end());
    emu_write(argv[2], out);
    return 0;
}
