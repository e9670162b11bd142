// MoE routing-plan kernel for Hopper (sm_90a): from the router's softmax to
// the integer maps the MoE layer's gathers need, in one launch.  Per group
// of tokens: the stable top-k of each token's gates, the gates renormalised
// and cast to the model's dtype, each (token, choice) pair's FIFO ticket
// from its expert and its slot (-1 past the capacity), the kept mask, the
// combine's gather index, the dispatch's slot->token map and its mask, and
// the aux loss's per-group partials (first-choice counts, gate column sums).
//
// Replaces the Pallas kernel _ticket_kernel
// (src/repro/kernels/ticket_dispatch/kernel.py:34, pl.pallas_call at line
// 72) on the serve path, together with the plain ops around it that the
// reference leaves to XLA inside one jit (src/repro/models/layers.py:336-
// 365: lax.top_k, the renormalisation, the aux loss's one-hot, the where of
// dispatch_combine_plan, the flat index and the slot->token scatter).  In
// eager PyTorch those ops were about 28 launches a layer, each costing the
// host more than the device's work; here they are one.  The standalone
// ticket kernel (ticket_dispatch.cu) stays for assign_slots; both walk the
// tickets with the same device function (td_walk).
//
// The router's GEMM, its cast to float32 and the softmax stay in PyTorch:
// the GEMM is a plain product that the reference leaves to XLA, and the
// softmax stays outside so that the gates, and so the served tokens, are
// bit-identical to the plain path (dispatch="torch").  The kernel then
// reproduces the plain version bit for bit: the stable order by exact key
// compares, the renormalising sum left to right with __fadd_rn (the plain
// version sums the same way), IEEE division (__fdiv_rn; the build uses no
// fast-math flag), bf16 by __float2bfloat16_rn (round to nearest even, as
// PyTorch's cast; a NaN would differ in its bits).
//
// What bounds it on this card: bytes, 4 per gate read (N x E float32) and
// about 20 per (token, choice) pair and 9 per buffer slot written; at
// granite-moe's decode group (8 tokens, E 32, K 8) that is nanoseconds, so
// the launch and the block's dependent steps are what it costs (0.0040 ms
// alone on an H100 beside a launch floor of 0.00115, PERF.md §6).  One
// block a group (the tickets are a sequential prefix count, and blocks run
// in no order); within it one warp a token for the top-k (the rank of each
// lane from E broadcasts, then K ballots), and the ticket walk of
// ticket_dispatch_kernel.cuh.  E <= 32 (one lane an expert) and K <= E,
// which covers every MoE config of the port (granite E 32 K 8, grok-1 E 8
// K 2).
//
// Built by repro_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain C shared library, loaded with ctypes; the constants header it
// includes (TD_THREADS, MP_STAGE, MP_MAX_EXPERTS) is generated from
// repro_torch/kernels/ticket_dispatch/plan.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moe_plan_kernel.cuh"

template <bool BF16>
__global__ void __launch_bounds__(TD_THREADS)
moe_plan_kernel(const float *__restrict__ gates_full, int N, int E, int K,
                int cap, int32_t *__restrict__ top_ids, void *gates,
                int32_t *__restrict__ slot, uint8_t *__restrict__ kept,
                int64_t *__restrict__ safe_idx,
                int64_t *__restrict__ slot_tok, uint8_t *__restrict__ valid,
                float *__restrict__ first_counts,
                float *__restrict__ gate_sums) {
    extern __shared__ __align__(16) unsigned char mp_smem[];
    const int64_t g = blockIdx.x;
    const int64_t pairs = g * N * K, slots = g * E * cap;
    void *gates_g = BF16 ? (void *)((uint16_t *)gates + pairs)
                         : (void *)((float *)gates + pairs);
    mp_group<BF16>(gates_full + g * N * E, N, E, K, cap, top_ids + pairs,
                   gates_g, slot + pairs, kept + pairs, safe_idx + pairs,
                   slot_tok + slots, valid + slots, first_counts + g * E,
                   gate_sums + g * E, threadIdx.x, mp_smem);
}

// Bytes of dynamic shared memory one block takes for n_experts experts and
// groups of n_tokens tokens choosing top_k each.
extern "C" int64_t moe_plan_smem_bytes(int n_experts, int n_tokens,
                                       int top_k) {
    const int64_t chunk = MP_STAGE / top_k;
    return mp_smem_bytes(n_experts,
                         (n_tokens < chunk ? n_tokens : chunk) * top_k);
}

// The plan of `groups` groups of n_tokens tokens (gates_full: groups x
// n_tokens x n_experts float32, contiguous) into the outputs, each
// contiguous and group-major (see mp_group), one block a group, on
// `stream`.  gates is bf16 if `bf16`, else float32.  Returns the CUDA error
// of the launch (0 = launched, or nothing to do); it does not synchronise.
extern "C" int moe_plan_run(const void *gates_full, void *top_ids,
                            void *gates, void *slot, void *kept,
                            void *safe_idx, void *slot_tok, void *valid,
                            void *first_counts, void *gate_sums, int groups,
                            int n_tokens, int n_experts, int top_k,
                            int capacity, int bf16, void *stream) {
    if (groups < 0 || n_tokens < 0 || n_experts < 1 ||
        n_experts > MP_MAX_EXPERTS || top_k < 1 || top_k > n_experts ||
        capacity < 1)
        return (int)cudaErrorInvalidValue;
    if (groups == 0 || n_tokens == 0)
        return 0;
    const int64_t smem = moe_plan_smem_bytes(n_experts, n_tokens, top_k);
    if (smem > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        moe_plan_kernel<true><<<groups, TD_THREADS, (size_t)smem, s>>>(
            (const float *)gates_full, n_tokens, n_experts, top_k, capacity,
            (int32_t *)top_ids, gates, (int32_t *)slot, (uint8_t *)kept,
            (int64_t *)safe_idx, (int64_t *)slot_tok, (uint8_t *)valid,
            (float *)first_counts, (float *)gate_sums);
    else
        moe_plan_kernel<false><<<groups, TD_THREADS, (size_t)smem, s>>>(
            (const float *)gates_full, n_tokens, n_experts, top_k, capacity,
            (int32_t *)top_ids, gates, (int32_t *)slot, (uint8_t *)kept,
            (int64_t *)safe_idx, (int64_t *)slot_tok, (uint8_t *)valid,
            (float *)first_counts, (float *)gate_sums);
    return (int)cudaGetLastError();
}
