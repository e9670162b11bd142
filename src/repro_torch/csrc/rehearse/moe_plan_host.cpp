// Host rehearsal of the MoE routing-plan kernel's device code
// (moe_plan_kernel.cuh): the same mp_group that moe_plan.cu launches, each
// group's TD_THREADS threads run as host threads (warp_emu.h), the groups
// one after another.
//
//   moe_plan_host IN OUT
//
// IN holds int32 words: groups, n_tokens, n_experts, top_k, capacity, bf16,
// then gates_full's float32 bits (groups x n_tokens x n_experts).  OUT
// receives the outputs' bytes in the order of moe_plan_run's arguments
// (top_ids, gates, slot, kept, safe_idx, slot_tok, valid, first_counts,
// gate_sums), each padded to a whole word.  Built by repro_torch/rehearse.py
// with the generated constants header.
#include "warp_emu.h"

#include "moe_plan_kernel.cuh"

int main(int argc, char **argv) {
    if (argc != 3) {
        std::fprintf(stderr, "usage: %s IN OUT\n", argv[0]);
        return 2;
    }
    std::vector<uint32_t> words = emu_read(argv[1]);
    const int32_t *w = (const int32_t *)words.data();
    const int G = w[0], N = w[1], E = w[2], K = w[3], cap = w[4];
    const bool bf16 = w[5] != 0;
    if (words.size() != 6 + (size_t)G * N * E) {
        std::fprintf(stderr, "moe_plan_host: %zu words, expected %lld\n",
                     words.size(), 6 + (long long)G * N * E);
        return 2;
    }
    const float *gates_full = (const float *)(w + 6);
    const size_t pairs = (size_t)G * N * K, slots = (size_t)G * E * cap;
    std::vector<int32_t> top_ids(pairs), slot(pairs);
    std::vector<uint16_t> gates16(pairs);
    std::vector<float> gates32(pairs), first_counts((size_t)G * E),
        gate_sums((size_t)G * E);
    std::vector<uint8_t> kept(pairs), valid(slots);
    std::vector<int64_t> safe_idx(pairs), slot_tok(slots);
    const int64_t chunk = MP_STAGE / K;
    const int64_t smem_bytes = mp_smem_bytes(E, (N < chunk ? N : chunk) * K);
    for (int g = 0; g < G; ++g) {
        // filled with a pattern, so a word read before it is written shows
        std::vector<uint64_t> smem((smem_bytes + 7) / 8, 0x7777777777777777u);
        const size_t p = (size_t)g * N * K, s = (size_t)g * E * cap;
        void *gates_g = bf16 ? (void *)(gates16.data() + p)
                             : (void *)(gates32.data() + p);
        emu_block(TD_THREADS, [&](int tid) {
            if (bf16)
                mp_group<true>(gates_full + (size_t)g * N * E, N, E, K, cap,
                               top_ids.data() + p, gates_g, slot.data() + p,
                               kept.data() + p, safe_idx.data() + p,
                               slot_tok.data() + s, valid.data() + s,
                               first_counts.data() + g * E,
                               gate_sums.data() + g * E, tid,
                               (unsigned char *)smem.data());
            else
                mp_group<false>(gates_full + (size_t)g * N * E, N, E, K, cap,
                                top_ids.data() + p, gates_g, slot.data() + p,
                                kept.data() + p, safe_idx.data() + p,
                                slot_tok.data() + s, valid.data() + s,
                                first_counts.data() + g * E,
                                gate_sums.data() + g * E, tid,
                                (unsigned char *)smem.data());
        });
    }
    std::vector<uint32_t> out;
    auto put = [&](const void *data, size_t bytes) {
        const size_t at = out.size();
        out.resize(at + (bytes + 3) / 4, 0);
        std::memcpy(out.data() + at, data, bytes);
    };
    put(top_ids.data(), pairs * 4);
    if (bf16)
        put(gates16.data(), pairs * 2);
    else
        put(gates32.data(), pairs * 4);
    put(slot.data(), pairs * 4);
    put(kept.data(), pairs);
    put(safe_idx.data(), pairs * 8);
    put(slot_tok.data(), slots * 8);
    put(valid.data(), slots);
    put(first_counts.data(), (size_t)G * E * 4);
    put(gate_sums.data(), (size_t)G * E * 4);
    emu_write(argv[2], out);
    return 0;
}
