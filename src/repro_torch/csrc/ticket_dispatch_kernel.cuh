// Device code of the ticket-dispatch kernel: one group's FIFO tickets.
// Included by ticket_dispatch.cu.  It uses only __syncthreads, __syncwarp,
// __match_any_sync and __popc, so it can be compiled on a host with those
// defined (threads and barriers) to check it without a card.
#pragma once

#include <stdint.h>

#ifndef TD_THREADS
#error "TD_THREADS comes from the generated constants header"
#endif
#define TD_WARPS (TD_THREADS / 32)

// Tickets and slots of the n arrivals ids[0..n) of one group, in arrival
// order.  `tid` is the thread's index in the block of TD_THREADS threads;
// `smem` holds (TD_WARPS + 1) * n_experts words:
//   counters[e]          arrivals to expert e in the chunks walked so far;
//   warp_count[w][e]     arrivals of warp w to expert e in this chunk, then
//                        the ticket of the first of them.
// Each chunk of TD_THREADS arrivals is ranked in three steps: within a
// warp, lanes with the same expert find each other (__match_any_sync) and
// each counts its peers on lower lanes; the peer group's first lane writes
// the group's size; one thread per expert walks the warps in order and
// turns the sizes into first tickets, carrying counters[e] into the next
// chunk.  Order is arrival order throughout: no atomics.
__device__ __forceinline__ void td_group(const int32_t *__restrict__ ids,
                                         int32_t *__restrict__ tickets,
                                         int32_t *__restrict__ slots,
                                         int64_t n, int n_experts,
                                         int capacity, int tid,
                                         int32_t *smem) {
    int32_t *counters = smem;
    int32_t *warp_count = smem + n_experts;
    const int lane = tid & 31, warp = tid >> 5;
    const unsigned lanes_below = (1u << lane) - 1u;
    for (int i = tid; i < (TD_WARPS + 1) * n_experts; i += TD_THREADS)
        smem[i] = 0;
    __syncthreads();
    for (int64_t start = 0; start < n; start += TD_THREADS) {
        const int64_t i = start + tid;
        const int id = i < n ? ids[i] : -1;
        // an id outside [0, E) (or past the end) takes no counter
        const bool valid = id >= 0 && id < n_experts;
        const unsigned peers = __match_any_sync(0xffffffffu,
                                                valid ? id : -1);
        const int rank = __popc(peers & lanes_below);
        int32_t *mine = warp_count + warp * n_experts + (valid ? id : 0);
        if (valid && rank == 0)
            *mine = __popc(peers);
        __syncthreads();
        for (int e = tid; e < n_experts; e += TD_THREADS) {
            int32_t run = counters[e];
            for (int w = 0; w < TD_WARPS; ++w) {
                const int32_t c = warp_count[w * n_experts + e];
                if (c) {                 // only warps holding e read it
                    warp_count[w * n_experts + e] = run;
                    run += c;
                }
            }
            counters[e] = run;
        }
        __syncthreads();
        if (i < n) {
            const int32_t t = valid ? *mine + rank : -1;
            tickets[i] = t;
            slots[i] = (valid && t < capacity) ? t : -1;
        }
        __syncwarp();                    // every lane has read *mine
        if (valid && rank == 0)
            *mine = 0;                   // zero again for the next chunk
        __syncwarp();
    }
}
