// Device code of the ticket-dispatch kernel: one group's FIFO tickets.
// Included by ticket_dispatch.cu.  It uses only __syncthreads, __syncwarp,
// __match_any_sync, __ballot_sync and __popc, so it can be compiled on a
// host with those defined (csrc/rehearse/warp_emu.h) to check it without a
// card.
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
//                        the running count of e before warp w.
// Each chunk of TD_THREADS arrivals is ranked in three steps: within a
// warp, lanes of the same column find each other (__match_any_sync) and
// each counts the valid peers on lower lanes; the first valid lane of a
// column writes how many valid lanes hold it; one thread per expert walks
// the warps in order and turns the counts into running counts for every
// warp, carrying counters[e] into the next chunk.  Order is arrival order
// throughout: no atomics.
//
// The ids outside [0, E) follow JAX's gather rule, as the reference's
// ticket_ref does: an id in [-E, 0) is wrapped to the column id + E and
// takes the count of earlier valid arrivals there (its warp's running
// count plus the valid lanes below it) without moving a counter; any
// other id takes INT32_MIN.  That is why the walk writes every warp's
// running count, not only those of the warps that hold the expert, and
// why each warp then zeroes its whole row.  slot = ticket if ticket <
// capacity else -1, so INT32_MIN stays the slot.
__device__ __forceinline__ void td_group(const int32_t *__restrict__ ids,
                                         int32_t *__restrict__ tickets,
                                         int32_t *__restrict__ slots,
                                         int64_t n, int n_experts,
                                         int capacity, int tid,
                                         int32_t *smem) {
    int32_t *counters = smem;
    int32_t *warp_count = smem + n_experts;
    int32_t *row = warp_count + (tid >> 5) * n_experts;
    const int lane = tid & 31;
    const unsigned lanes_below = (1u << lane) - 1u;
    for (int i = tid; i < (TD_WARPS + 1) * n_experts; i += TD_THREADS)
        smem[i] = 0;
    __syncthreads();
    for (int64_t start = 0; start < n; start += TD_THREADS) {
        const int64_t i = start + tid;
        const int id = i < n ? ids[i] : INT32_MIN;
        const bool valid = id >= 0 && id < n_experts;
        // the column the id reads: itself, wrapped once, or none (-1)
        const int col = valid ? id
                        : (id < 0 && id >= -n_experts) ? id + n_experts
                                                       : -1;
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
        if (i < n) {
            const int32_t t = col >= 0 ? row[col] + rank : INT32_MIN;
            tickets[i] = t;
            slots[i] = t < capacity ? t : -1;
        }
        __syncwarp();                    // every lane has read its column
        for (int e = lane; e < n_experts; e += 32)
            row[e] = 0;                  // zero again for the next chunk
        __syncwarp();
    }
}
