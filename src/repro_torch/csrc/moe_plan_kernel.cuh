// Device code of the MoE routing-plan kernel: one group's top-k, FIFO
// tickets, slots, the slot->token map and the aux-loss partials.  Included
// by moe_plan.cu.  Besides what ticket_dispatch_kernel.cuh uses it takes
// __shfl_sync, __ffs, __float_as_uint, __fadd_rn, __fdiv_rn and
// __float2bfloat16_rn, all defined for the host by csrc/rehearse/warp_emu.h,
// so the rehearsal compiles it with g++.
#pragma once

#include <stdint.h>

#include "ticket_dispatch_kernel.cuh"

#if !defined(MP_STAGE) || !defined(MP_MAX_EXPERTS)
#error "MP_STAGE and MP_MAX_EXPERTS come from the generated constants header"
#endif
static_assert(MP_MAX_EXPERTS <= 32, "one lane an expert in the top-k");
static_assert(MP_STAGE >= MP_MAX_EXPERTS, "a chunk holds a token or more");

// A key whose unsigned order is torch.sort's order of the float: NaN above
// every number, -0.0 equal to +0.0, otherwise the float's own order.  The
// gates are softmax outputs, exp(x - max) / sum: never -0.0 (exp gives +0.0
// at worst, and +0.0 / a positive sum is +0.0), and NaN only where a logit
// is NaN or infinite; the key keeps the order right either way.
__device__ __forceinline__ unsigned mp_key(float g) {
    unsigned u = __float_as_uint(g);
    if (g != g)
        return 0xffffffffu;
    if (u == 0x80000000u)
        u = 0;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Bytes of shared memory of one block: per (warp, expert) the gate sums
// (doubles, first) and the first-choice counts, then the walk's words
// (td_smem_words), then the stage of `stage` arrivals' expert ids.
__host__ __device__ __forceinline__ int64_t mp_smem_bytes(int n_experts,
                                                          int64_t stage) {
    return 8 * (int64_t)TD_WARPS * n_experts +
           4 * ((int64_t)TD_WARPS * n_experts + td_smem_words(n_experts) +
                stage);
}

// The plan of one group of N tokens, from gates_full (N, E) float32, the
// router's softmax.  Writes, per (token n, choice k), a = n * K + k:
//   top_ids[a]   the k-th largest gate's expert, ties to the lower index
//                (lax.top_k's order);
//   gates[a]     its gate over the left-to-right float32 sum of the token's
//                K top gates (clamped to 1e-9), in float32 or bf16 (BF16),
//                zero where the pair is dropped;
//   slot[a]      its FIFO ticket from its expert if below `cap`, else -1;
//   kept[a]      slot >= 0;
//   safe_idx[a]  min(e * cap + slot, E * cap - 1), and E * cap - 1 where
//                dropped (the combine's gather index);
// and per buffer slot f of the E * cap: slot_tok[f] the token in it (0 where
// empty) and valid[f] whether one is; per expert: first_counts[e] the tokens
// whose first choice is e, gate_sums[e] the sum of gates_full[:, e] (in
// double, in a fixed order, rounded once).
//
// One warp a token for the top-k: lane e holds gate e; its rank is the
// count of lanes whose key is larger, or equal on a lower lane (E
// broadcasts, unrolled, no dependent rounds); then for each k < K a ballot
// finds the lane of rank k and a broadcast brings its gate, summed left to
// right.  Every shuffle, ballot and barrier sits in control flow that
// depends on the kernel's arguments alone: where the compiler cannot see
// that a branch around one is the same in all of a warp's threads, it
// wraps the warp operation in code for a divergent warp, which cost more
// than the work itself.  Tokens go in chunks of MP_STAGE / K, their ids
// staged in shared memory, and the ticket walk td_group would take for the
// group's N * K arrivals (td_walk, one pass, or td_walk_chunks) tickets
// each chunk in arrival order (token-major), carrying the counters.  Kept
// slots are unique (a ticket is a FIFO position), so each slot->token entry
// is written once, after the block has cleared them all.
template <bool BF16>
__device__ __forceinline__ void mp_group(
    const float *__restrict__ gates_full, int N, int E, int K, int cap,
    int32_t *__restrict__ top_ids, void *__restrict__ gates,
    int32_t *__restrict__ slot, uint8_t *__restrict__ kept,
    int64_t *__restrict__ safe_idx, int64_t *__restrict__ slot_tok,
    uint8_t *__restrict__ valid, float *__restrict__ first_counts,
    float *__restrict__ gate_sums, int tid, unsigned char *smem) {
    const unsigned full = 0xffffffffu;
    double *sums_part = (double *)smem;                // [TD_WARPS][E]
    int32_t *firsts_part = (int32_t *)(sums_part + TD_WARPS * E);
    int32_t *walk = firsts_part + TD_WARPS * E;        // td_smem_words(E)
    int32_t *stage = walk + td_smem_words(E);          // [MP_STAGE]
    const int warp = tid >> 5, lane = tid & 31;
    const int64_t n_slots = (int64_t)E * cap;
    // the walk as td_group picks it for the whole group's N * K arrivals
    const bool one_pass = td_one_pass((int64_t)N * K, E);
    for (int i = tid; i < (TD_WARPS + 1) * E; i += TD_THREADS)
        walk[i] = 0;                     // td_walk_chunks's counters, rows
    for (int64_t f = tid; f < n_slots; f += TD_THREADS) {
        slot_tok[f] = 0;
        valid[f] = 0;
    }
    const bool expert = lane < E;
    const int chunk = MP_STAGE / K;                    // tokens a chunk
    double sum = 0.0;
    int32_t firsts = 0, carry = 0;
    for (int c0 = 0; c0 < N; c0 += chunk) {
        const int c1 = N - c0 < chunk ? N : c0 + chunk;
        // rounds of one token a warp: a count the same in every thread, so
        // the warp's shuffles and ballots sit in uniform control flow (a
        // warp past the last token works on zeros and stores nothing)
        const int rounds = (c1 - c0 + TD_WARPS - 1) / TD_WARPS;
        for (int r = 0; r < rounds; ++r) {
            const int n = c0 + r * TD_WARPS + warp;
            const bool token = n < c1;
            const float g = expert && token
                                ? gates_full[(int64_t)n * E + lane] : 0.f;
            const unsigned key = expert ? mp_key(g) : 0u;
            int rank = 0;
#pragma unroll
            for (int j = 0; j < MP_MAX_EXPERTS; ++j) {
                const unsigned kj = __shfl_sync(full, key, j);
                rank += j < E && ((kj > key) | ((kj == key) & (j < lane)));
            }
            sum += g;                                  // 0 on other lanes
            firsts += expert && token && rank == 0;
            // the lane of rank k and its gate, summed left to right
            float total = 0.f, mine = 0.f;
            int mine_id = 0;
            for (int k = 0; k < K; ++k) {
                const int src =
                    __ffs(__ballot_sync(full, expert && rank == k)) - 1;
                const float v = __shfl_sync(full, g, src);
                total = k == 0 ? v : __fadd_rn(total, v);
                mine = lane == k ? v : mine;
                mine_id = lane == k ? src : mine_id;
            }
            if (token && lane < K) {
                // clamp_min(1e-9), which keeps a NaN
                const float denom = total < 1e-9f ? 1e-9f : total;
                const float out = __fdiv_rn(mine, denom);
                const int64_t a = (int64_t)n * K + lane;
                top_ids[a] = mine_id;
                if (BF16)
                    ((uint16_t *)gates)[a] =
                        __bfloat16_as_ushort(__float2bfloat16_rn(out));
                else
                    ((float *)gates)[a] = out;
                stage[(n - c0) * K + lane] = mine_id;
            }
        }
        __syncthreads();                 // the stage and the cleared map
        const int64_t a0 = (int64_t)c0 * K;
        auto visit = [&](int j, int col, int32_t t) {
            const int64_t a = a0 + j;
            const int32_t s = t < cap ? t : -1;
            slot[a] = s;
            kept[a] = s >= 0;
            const int64_t f = s >= 0 ? (int64_t)col * cap + s
                                     : n_slots;
            safe_idx[a] = f < n_slots - 1 ? f : n_slots - 1;
            if (s >= 0) {
                slot_tok[f] = (int32_t)a / K;
                valid[f] = 1;
            } else if (BF16) {
                ((uint16_t *)gates)[a] = 0;
            } else {
                ((float *)gates)[a] = 0.f;
            }
        };
        if (one_pass)
            td_walk((c1 - c0) * K, E, tid, walk, carry,
                    [&](int j) { return stage[j]; }, visit);
        else
            td_walk_chunks(stage, (c1 - c0) * K, E, tid, walk, visit);
        __syncthreads();                 // every warp is done with the stage
    }
    if (expert) {
        sums_part[warp * E + lane] = sum;
        firsts_part[warp * E + lane] = firsts;
    }
    __syncthreads();
    for (int e = tid; e < E; e += TD_THREADS) {
        double s = 0.0;
        int32_t c = 0;
        for (int w = 0; w < TD_WARPS; ++w) {
            s += sums_part[w * E + e];
            c += firsts_part[w * E + e];
        }
        gate_sums[e] = (float)s;
        first_counts[e] = (float)c;
    }
}
