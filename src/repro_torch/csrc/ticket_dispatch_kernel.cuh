// Device code of the ticket walk: each arrival's FIFO ticket, its count of
// earlier arrivals to the same expert.  Included by ticket_dispatch.cu
// (td_group, one group a block) and by moe_plan_kernel.cuh (the
// routing-plan kernel walks its staged top-k ids with the same functions).
// It uses only __syncthreads, __syncwarp, __match_any_sync, __ballot_sync,
// __shfl_sync and __popc, so it can be compiled on a host with those
// defined (csrc/rehearse/warp_emu.h) to check it without a card.
//
// Two walks, each where it was measured faster on an H100 (PERF.md §6): a
// long group (more arrivals than threads) with at most 32 experts takes
// td_walk, one pass; a short group, or more than 32 experts, takes
// td_walk_chunks, chunks of TD_THREADS arrivals.
//
// The ids outside [0, E) follow JAX's gather rule, as the reference's
// ticket_ref does: an id in [-E, 0) is wrapped to the column id + E and
// takes the count of earlier valid arrivals there without moving a
// counter; any other id takes INT32_MIN (column -1).
#pragma once

#include <stdint.h>

#ifndef TD_THREADS
#error "TD_THREADS comes from the generated constants header"
#endif
#define TD_WARPS (TD_THREADS / 32)
// Strips of 32 arrivals each warp holds in registers in td_walk, and the
// arrivals of one of its chunks
#define TD_STRIPS 8
#define TD_CHUNK (TD_STRIPS * TD_THREADS)

// The column an id reads: itself, wrapped once, or none (-1).
__device__ __forceinline__ int td_col(int id, int n_experts) {
    return (id >= 0 && id < n_experts) ? id
           : (id < 0 && id >= -n_experts) ? id + n_experts
                                          : -1;
}

// Per lane, the ballots of the six bits of its key (keys in [0, 64)), and
// the lanes whose key is `key`.
__device__ __forceinline__ void td_vote(unsigned *vote, int key) {
#pragma unroll
    for (int b = 0; b < 6; ++b)
        vote[b] = __ballot_sync(0xffffffffu, (key >> b) & 1);
}
__device__ __forceinline__ unsigned td_holders(const unsigned *vote,
                                               int key) {
    unsigned lanes = 0xffffffffu;
#pragma unroll
    for (int b = 0; b < 6; ++b)
        lanes &= (key >> b) & 1 ? vote[b] : ~vote[b];
    return lanes;
}

// One pass over n arrivals with at most 32 experts: arrival i's id is
// load(i), and visit(i, col, ticket) takes its ticket.  `tid` is the
// thread's index in the block of TD_THREADS threads (every thread calls
// it); `rows` holds 2 * TD_WARPS * n_experts words; `carry` is each
// expert's arrivals before these (lane e holds expert e's), the same in
// every warp, and moves on past them.
//
// The arrivals go in chunks of TD_CHUNK.  Warp w owns a contiguous run of
// each chunk, TD_STRIPS strips of 32 at most, and loads them into registers
// at once (one memory round trip a chunk).  Lane e keeps expert e's counts
// in a register, and one ballot per bit of the key col + 1 (a warp
// multi-split) gives each lane both the lanes of its own expert (its rank)
// and the count of lane e's expert in the strip.  Each warp writes its
// run's counts to its row; after one barrier every lane e sums expert e's
// rows of the warps before its own (its start) and of all warps (the next
// carry); then the warp walks its run again, each arrival's ticket its
// expert's running count (a broadcast from lane col) plus its rank among
// the valid lanes of its expert below it.  The rows alternate between two
// buffers, so a chunk's barrier also frees the buffer of the chunk before.
// One barrier a chunk, no atomics, no shared memory inside a strip.  The
// count of strips depends on n alone, so every ballot sits in control flow
// the compiler sees as the same in all of a warp's threads: where it
// cannot, it wraps each warp operation in code for a divergent warp, which
// cost more than the walk itself.
template <class Load, class Visit>
__device__ __forceinline__ void td_walk(int n, int n_experts, int tid,
                                        int32_t *rows, int32_t &carry,
                                        Load &&load, Visit &&visit) {
    const unsigned full = 0xffffffffu;
    const int warp = tid >> 5, lane = tid & 31;
    const unsigned lanes_below = (1u << lane) - 1u;
    const bool expert = lane < n_experts;
    unsigned vote[6];
    int32_t *buf = rows;
    for (int c0 = 0; c0 < n; c0 += TD_CHUNK) {
        const int m = n - c0 < TD_CHUNK ? n - c0 : TD_CHUNK;
        const int run = ((m + TD_WARPS - 1) / TD_WARPS + 31) / 32 * 32;
        const int strips = run / 32;
        const int lo = c0 + warp * run;
        const int hi = lo + run < c0 + m ? lo + run : c0 + m;
        int id[TD_STRIPS];
#pragma unroll
        for (int k = 0; k < TD_STRIPS; ++k) {
            const int i = lo + 32 * k + lane;
            id[k] = i < hi ? load(i) : INT32_MIN;
        }
        int32_t count = 0;
#pragma unroll
        for (int k = 0; k < TD_STRIPS; ++k) {
            if (k < strips) {
                const bool valid = id[k] >= 0 && id[k] < n_experts;
                td_vote(vote, valid ? id[k] + 1 : 0);
                count += __popc(td_holders(vote, lane + 1));
            }
        }
        if (expert)
            buf[warp * n_experts + lane] = count;
        __syncthreads();
        int32_t start = carry;
#pragma unroll
        for (int w = 0; w < TD_WARPS; ++w) {
            const int32_t c = expert ? buf[w * n_experts + lane] : 0;
            start += w < warp ? c : 0;
            carry += c;
        }
#pragma unroll
        for (int k = 0; k < TD_STRIPS; ++k) {
            if (k < strips) {
                const bool valid = id[k] >= 0 && id[k] < n_experts;
                const int col = td_col(id[k], n_experts);
                td_vote(vote, col + 1);
                const unsigned valid_lanes = __ballot_sync(full, valid);
                const int rank = __popc(td_holders(vote, col + 1) &
                                        valid_lanes & lanes_below);
                const int32_t base =
                    __shfl_sync(full, start, col < 0 ? 0 : col);
                start += __popc(td_holders(vote, lane + 1) & valid_lanes);
                const int i = lo + 32 * k + lane;
                if (i < hi)
                    visit(i, col, col >= 0 ? base + rank : INT32_MIN);
            }
        }
        buf = buf == rows ? rows + TD_WARPS * n_experts : rows;
    }
}

// The walk in chunks of TD_THREADS arrivals, one a thread (the design of
// the ticket kernel before td_walk, kept for short groups, where it is
// faster, and for more than 32 experts): within a warp, lanes of the same
// column find each other (__match_any_sync) and count the valid peers on
// lower lanes; the first valid lane of a column writes how many valid
// lanes hold it; one thread per expert walks the warps in order and turns
// the counts into running counts for every warp (a wrapped id needs its
// column's count even where its warp holds none), carrying counters[e]
// into the next chunk.  `smem` holds (TD_WARPS + 1) * n_experts words, zero
// on entry: the counters, then a row a warp.
template <class Visit>
__device__ __forceinline__ void td_walk_chunks(const int32_t *ids, int n,
                                               int n_experts, int tid,
                                               int32_t *smem,
                                               Visit &&visit) {
    int32_t *counters = smem;
    int32_t *warp_count = smem + n_experts;
    int32_t *row = warp_count + (tid >> 5) * n_experts;
    const int lane = tid & 31;
    const unsigned lanes_below = (1u << lane) - 1u;
    for (int start = 0; start < n; start += TD_THREADS) {
        const int i = start + tid;
        const int id = i < n ? ids[i] : INT32_MIN;
        const bool valid = id >= 0 && id < n_experts;
        const int col = td_col(id, n_experts);
        const unsigned peers = __match_any_sync(0xffffffffu, col) &
                               __ballot_sync(0xffffffffu, valid);
        const int rank = __popc(peers & lanes_below);
        if (valid && rank == 0)
            row[id] = __popc(peers);
        __syncthreads();
        for (int e = tid; e < n_experts; e += TD_THREADS) {
            int32_t run = counters[e];
            for (int w = 0; w < TD_WARPS; ++w) {
                const int32_t c = warp_count[w * n_experts + e];
                warp_count[w * n_experts + e] = run;
                run += c;
            }
            counters[e] = run;
        }
        __syncthreads();
        if (i < n)
            visit(i, col, col >= 0 ? row[col] + rank : INT32_MIN);
        __syncwarp();                    // every lane has read its column
        for (int e = lane; e < n_experts; e += 32)
            row[e] = 0;                  // zero again for the next chunk
        __syncwarp();
    }
}

// Whether a group of n arrivals takes td_walk (else td_walk_chunks).
__host__ __device__ __forceinline__ bool td_one_pass(int64_t n,
                                                     int n_experts) {
    return n_experts <= 32 && n > TD_THREADS;
}

// Words of shared memory either walk takes: td_walk's two buffers of rows
// up to 32 experts, td_walk_chunks's counters and rows.
__host__ __device__ __forceinline__ int64_t td_smem_words(int n_experts) {
    const int64_t chunks = (int64_t)(TD_WARPS + 1) * n_experts;
    const int64_t one_pass = 2 * (int64_t)TD_WARPS * n_experts;
    return n_experts <= 32 && one_pass > chunks ? one_pass : chunks;
}

// Tickets and slots of the n arrivals ids[0..n) of one group, in arrival
// order: slot = ticket if ticket < capacity else -1, so INT32_MIN stays the
// slot.  `smem` holds td_smem_words(n_experts) words.
__device__ __forceinline__ void td_group(const int32_t *__restrict__ ids,
                                         int32_t *__restrict__ tickets,
                                         int32_t *__restrict__ slots,
                                         int n, int n_experts, int capacity,
                                         int tid, int32_t *smem) {
    auto visit = [&](int i, int, int32_t t) {
        tickets[i] = t;
        slots[i] = t < capacity ? t : -1;
    };
    if (td_one_pass(n, n_experts)) {
        int32_t carry = 0;
        td_walk(n, n_experts, tid, smem, carry,
                [&](int i) { return ids[i]; }, visit);
        return;
    }
    for (int i = tid; i < (TD_WARPS + 1) * n_experts; i += TD_THREADS)
        smem[i] = 0;
    __syncthreads();
    td_walk_chunks(ids, n, n_experts, tid, smem, visit);
}
