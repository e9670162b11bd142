// Ticket-dispatch kernel for Hopper (sm_90a): each MoE routing decision's
// FIFO ticket, its position among the earlier arrivals to the same expert,
// and its slot (the ticket, or -1 once the ticket reaches the capacity).
//
// Replaces the Pallas kernel _ticket_kernel
// (src/repro/kernels/ticket_dispatch/kernel.py, wrapper
// ticket_dispatch_pallas, pl.pallas_call at line 72) and computes what its
// oracle ticket_ref computes.  It does not copy the Pallas block loop: on
// the TPU the grid ran in order, so a one-hot (BLOCK_N, E) matrix per grid
// step and per-expert counters in VMEM carried from step to step did the
// prefix count.  Blocks on Hopper run in no order, so here one thread
// block owns one group (G groups are G blocks of one launch) and walks its
// arrivals in order (ticket_dispatch_kernel.cuh).  A group of more
// arrivals than threads, with at most 32 experts, takes one pass: each
// warp counts a contiguous run held in registers with one ballot a bit of
// the id, one barrier, and each warp ranks its run from a running count a
// lane.  A shorter group, or more experts, takes chunks of TD_THREADS
// arrivals ranked by warp matching (__match_any_sync) and a serial walk
// over the warps, the design before, which was faster there (PERF.md §6).
// There is no per-arrival atomicAdd, whose order is not arrival order and
// would break the FIFO drop rule.  The MoE serve path runs the
// same walks inside the routing-plan kernel (moe_plan.cu); this kernel
// serves assign_slots and dispatch="ticket".
//
// What bounds it on this card: bytes, at 12 per arrival (the id read, the
// ticket and the slot written) over 3.35 TB/s — nanoseconds at a serve
// step's few thousand arrivals, so the launch (a few microseconds) and the
// block's chain of dependent steps are what it costs.
//
// Built by repro_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain C shared library, loaded with ctypes; the constants header it
// includes (TD_THREADS, TD_SMEM_LIMIT) is generated from
// repro_torch/kernels/ticket_dispatch/kernel.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ticket_dispatch_kernel.cuh"

__global__ void __launch_bounds__(TD_THREADS)
ticket_dispatch_kernel(const int32_t *__restrict__ ids,
                       int32_t *__restrict__ tickets,
                       int32_t *__restrict__ slots, int64_t n,
                       int n_experts, int capacity) {
    extern __shared__ __align__(16) int32_t td_smem[];
    const int64_t base = (int64_t)blockIdx.x * n;
    td_group(ids + base, tickets + base, slots + base, (int)n, n_experts,
             capacity, threadIdx.x, td_smem);
}

// Bytes of dynamic shared memory one block takes for n_experts experts.
extern "C" int64_t ticket_dispatch_smem_bytes(int n_experts) {
    return td_smem_words(n_experts) * (int64_t)sizeof(int32_t);
}

// Ticket `groups` rows of n int32 ids each (row-major, contiguous) into
// `tickets` and `slots` of the same layout, one block per row, on
// `stream`.  Returns the CUDA error of the launch (0 = launched, or nothing
// to do); it does not synchronise.
extern "C" int ticket_dispatch_run(const void *ids, void *tickets,
                                   void *slots, int64_t n, int groups,
                                   int n_experts, int capacity,
                                   void *stream) {
    if (n_experts < 1 || groups < 0 || n < 0 || n > INT32_MAX ||
        capacity < 0)
        return (int)cudaErrorInvalidValue;
    if (groups == 0 || n == 0)
        return 0;
    const int64_t smem = ticket_dispatch_smem_bytes(n_experts);
    if (smem > TD_SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            ticket_dispatch_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess)
            return (int)err;
    }
    ticket_dispatch_kernel<<<groups, TD_THREADS, (size_t)smem,
                             (cudaStream_t)stream>>>(
        (const int32_t *)ids, (int32_t *)tickets, (int32_t *)slots, n,
        n_experts, capacity);
    return (int)cudaGetLastError();
}
