// RG-LRU scan kernel for Hopper (sm_90a): the diagonal gated linear
// recurrence of Griffin / RecurrentGemma,
//   h_t = a_t * h_{t-1} + b_t,
// over a batch of sequences, h in float32, a, b and h0 read as float32 or
// bf16 each, y (every h_t) and h_final written in a's dtype.
//
// Replaces the Pallas kernel _rglru_kernel
// (src/repro/kernels/rglru/kernel.py:29, wrapper rglru_scan_pallas,
// pl.pallas_call at line 94) and keeps its contract, not its grid.  On the
// TPU the grid tiled D by 128 lanes and walked L in sequential 256-step
// chunks, each a Hillis-Steele scan of the affine maps (a, b) over VMEM
// tiles, with the float32 state carried in VMEM from grid step to grid
// step.  Blocks on Hopper run in no order, so here the sequential
// dimension is a loop inside one warp: each of its lanes keeps one
// channel's h in a register for all L steps.
//
// What bounds it on this card: bytes, 2 per bf16 element of a, b and y
// (L x D each) and h_final (D), over 3.35 TB/s; the operations (one
// multiply and one add per element) are far below the 32-bit rate.  For
// one prefill of recurrentgemma-9b (D 4,096, one sequence) that is 1.9
// microseconds at L 256 and 19 at L 2,600.  Below the bytes sits the chain
// of L dependent steps, a rounded multiply then a rounded add: reckoned at
// 8 cycles a step it is 10.5 us at L 2,600 and 1,980 MHz, so one chain per
// channel fits under the bytes bound if the card is full and the loads
// arrive ahead of it.  The design:
// - fill the card: a block is 32 channels, one chain warp's lanes, so one
//   sequence at D 4,096 is 128 blocks on the 132 SMs (the design before,
//   64 channels a block, left 68 SMs idle);
// - keep the loads ahead of the chain: a copy warp fills a ring of
//   RG_STAGES stages of RG_STEPS steps of a and b in shared memory with
//   16-byte cp.async copies, each stage's arrival counted by an mbarrier,
//   so after the first stage the chain reads shared memory and never waits
//   a memory round trip; it loads a whole stage into registers at once;
// - take y off the chain: the chain writes y_t over a_t in the stage, and
//   a store warp writes the stage's y back with 16-byte stores and frees
//   the slot for the copy warp.  The stores leave from their own warp: a
//   copy warp that also stored y paid a fixed cost every stage, more than
//   the chain itself (its copies' arrivals seem to wait behind its stores);
// - keep the arithmetic: an unfused __fmul_rn then __fadd_rn a step, h in
//   a float32 register, so float32 inputs equal the plain loop bit for
//   bit.
// The ring's shape, RG_STAGES = 6 stages of RG_STEPS = 64 steps (49 KB of
// bf16 a and b), was the fastest of the shapes timed at L 2,600 x D 4,096
// bf16 on an H100 80GB HBM3 at 700 W by a timing script not kept: 25.1 us,
// against 29.8 for 12 stages of 32 steps, 32.9 for 3 of 64 and 26.2 for 12
// of 64.  A stage is loaded into registers whole (64 raw words of a and of
// b a lane), without spills.  The chain runs at about twice its
// reckoned 8 cycles a step; what it waits on is not known.
// Layouts whose rows are not whole 16-byte pieces (rg_vec_ok: D not a
// multiple of 8 for bf16 or of 4 for float32, or unaligned tensors) take
// the same ring with one element per copy and store lane, each stage
// waiting one round trip of the copy warp; the serve's shapes do not.
// bf16 outputs round to nearest even by cvt.rn.bf16.f32 (a NaN becomes
// 0x7fff where PyTorch writes 0x7fc0).
//
// Built by repro_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain C shared library, loaded with ctypes; the constants header it
// includes (RG_CHANNELS, RG_THREADS, RG_STEPS, RG_STAGES, RG_BF16_*) is
// generated from repro_torch/kernels/rglru/kernel.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The ring's primitives (see rglru_scan_kernel.cuh).
__device__ __forceinline__ unsigned rg_shared(const void *p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void rg_bar_init(uint64_t *bar, unsigned n) {
    asm volatile("mbarrier.init.shared.b64 [%0], %1;"
                 :: "r"(rg_shared(bar)), "r"(n) : "memory");
}
__device__ __forceinline__ void rg_bar_arrive(uint64_t *bar) {
    asm volatile("{\n\t.reg .b64 state;\n\t"
                 "mbarrier.arrive.shared.b64 state, [%0];\n\t}"
                 :: "r"(rg_shared(bar)) : "memory");
}
__device__ __forceinline__ void rg_bar_wait(uint64_t *bar, unsigned par) {
    unsigned done;
    do {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(rg_shared(bar)), "r"(par)
                     : "memory");
    } while (!done);
}
__device__ __forceinline__ void rg_copy16(void *dst, const void *src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(rg_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void rg_copies_arrive(uint64_t *bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];"
                 :: "r"(rg_shared(bar)) : "memory");
}
__device__ __forceinline__ uint16_t rg_bf16(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

#include "rglru_scan_kernel.cuh"

template <bool BA, bool BB, bool VEC>
__global__ void __launch_bounds__(RG_THREADS)
rglru_scan_kernel(const void *a, const void *b, const void *h0, void *y,
                  void *hout, int L, int D, int64_t h0_bs, bool bh0) {
    extern __shared__ __align__(16) char rg_smem[];
    rg_block<BA, BB, VEC>(a, b, h0, y, hout, L, D, h0_bs, bh0, blockIdx.y,
                          blockIdx.x * RG_CHANNELS, threadIdx.x, rg_smem);
}

template <bool BA, bool BB, bool VEC>
static int rg_launch(dim3 grid, cudaStream_t st, const void *a,
                     const void *b, const void *h0, void *y, void *hout,
                     int L, int D, int64_t h0_bs, bool bh0) {
    const int smem = rg_smem_bytes(BA ? 2 : 4, BB ? 2 : 4);
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_scan_kernel<BA, BB, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess)
        return (int)err;
    rglru_scan_kernel<BA, BB, VEC><<<grid, RG_THREADS, smem, st>>>(
        a, b, h0, y, hout, L, D, h0_bs, bh0);
    return (int)cudaGetLastError();
}

template <bool BA, bool BB>
static int rg_launch_any(bool vec, dim3 grid, cudaStream_t st,
                         const void *a, const void *b, const void *h0,
                         void *y, void *hout, int L, int D, int64_t h0_bs,
                         bool bh0) {
    if (vec)
        return rg_launch<BA, BB, true>(grid, st, a, b, h0, y, hout, L, D,
                                       h0_bs, bh0);
    return rg_launch<BA, BB, false>(grid, st, a, b, h0, y, hout, L, D,
                                    h0_bs, bh0);
}

// Bytes of dynamic shared memory one block takes for the dtype mask bf16.
extern "C" int rglru_scan_smem_bytes(unsigned bf16) {
    return rg_smem_bytes(bf16 & RG_BF16_A ? 2 : 4, bf16 & RG_BF16_B ? 2 : 4);
}

// Scan `batch` sequences of L steps over D channels on `stream`; bf16 is
// the dtype mask (RG_BF16_A, _B, _H0).  Returns the CUDA error of the
// launch (0 = launched); it does not synchronise.
extern "C" int rglru_scan_run(const void *a, const void *b, const void *h0,
                              void *y, void *hout, int batch, int L, int D,
                              int64_t h0_bs, unsigned bf16, void *stream) {
    if (batch < 1 || batch > 65535 || L < 1 || D < 1)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((D + RG_CHANNELS - 1) / RG_CHANNELS),
                    (unsigned)batch);
    const bool ba = bf16 & RG_BF16_A, bb = bf16 & RG_BF16_B;
    const bool bh0 = bf16 & RG_BF16_H0;
    const bool vec = rg_vec_ok(a, b, y, D, ba ? 2 : 4, bb ? 2 : 4);
    cudaStream_t st = (cudaStream_t)stream;
    if (ba && bb)
        return rg_launch_any<true, true>(vec, grid, st, a, b, h0, y, hout,
                                         L, D, h0_bs, bh0);
    if (ba)
        return rg_launch_any<true, false>(vec, grid, st, a, b, h0, y, hout,
                                          L, D, h0_bs, bh0);
    if (bb)
        return rg_launch_any<false, true>(vec, grid, st, a, b, h0, y, hout,
                                          L, D, h0_bs, bh0);
    return rg_launch_any<false, false>(vec, grid, st, a, b, h0, y, hout, L,
                                       D, h0_bs, bh0);
}
