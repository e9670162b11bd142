// RG-LRU scan kernel for Hopper (sm_90a): the diagonal gated linear
// recurrence of Griffin / RecurrentGemma,
//   h_t = a_t * h_{t-1} + b_t,
// over a batch of sequences, h in float32, a, b and h0 read as float32 or
// bf16 each, y (every h_t) and h_final written in a's dtype.
//
// Replaces the Pallas kernel _rglru_kernel
// (src/repro/kernels/rglru/kernel.py, wrapper rglru_scan_pallas,
// pl.pallas_call at line 94) and keeps its contract, not its grid.  On the
// TPU the grid tiled D by 128 lanes and walked L in sequential 256-step
// chunks, each a Hillis-Steele scan of the affine maps (a, b) over VMEM
// tiles, with the float32 state carried in VMEM from grid step to grid
// step and a, b padded to whole tiles with the identity map (a=1, b=0).
// Blocks on Hopper run in no order, so here the sequential dimension is a
// loop inside the thread: one thread per (sequence, channel) keeps its h
// in a register for all L steps, loads a and b RG_CHUNK steps at a time
// into registers, every load of a chunk before the first use, and writes
// y_t at every step; a block holds RG_THREADS neighbouring channels and the
// grid is (channel blocks, sequences).  Nothing is padded: threads past D
// return at once.
//
// What bounds it on this card: bytes, 2 per bf16 element of a, b and y
// (L x D each) and h_final (D), over 3.35 TB/s; the operations (one
// multiply and one add per element) are far below the 32-bit rate.  For
// one prefill of recurrentgemma-9b (D 4,096) that is 1.9 microseconds at
// L 256 and 19 at L 2,600.  This simple design is bound instead by the
// serial chain of L dependent steps per thread, with one memory round trip
// every RG_CHUNK steps, and, at one sequence, by using only D / RG_THREADS
// = 64 of the 132 SMs; loads that overlap the chain (cp.async or TMA
// stages), a two-pass chunk-parallel form across blocks (the algebra of
// rglru_scan_chunked) and fusing the gates into the kernel are later work.
//
// Built by repro_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain C shared library, loaded with ctypes; the constants header it
// includes (RG_THREADS, RG_CHUNK, RG_BF16_*) is generated from
// repro_torch/kernels/rglru/kernel.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rglru_scan_kernel.cuh"

template <bool BA, bool BB>
__global__ void __launch_bounds__(RG_THREADS)
rglru_scan_kernel(const void *a, const void *b, const void *h0, void *y,
                  void *hout, int L, int D, int64_t h0_bs, bool bh0) {
    rg_channel<BA, BB>(a, b, h0, y, hout, L, D, h0_bs, bh0, blockIdx.y,
                       blockIdx.x * RG_THREADS + threadIdx.x);
}

// Scan `batch` sequences of L steps over D channels on `stream`; bf16 is
// the dtype mask (RG_BF16_A, _B, _H0).  Returns the CUDA error of the
// launch (0 = launched); it does not synchronise.
extern "C" int rglru_scan_run(const void *a, const void *b, const void *h0,
                              void *y, void *hout, int batch, int L, int D,
                              int64_t h0_bs, unsigned bf16, void *stream) {
    if (batch < 1 || batch > 65535 || L < 1 || D < 1)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((D + RG_THREADS - 1) / RG_THREADS),
                    (unsigned)batch);
    const bool ba = bf16 & RG_BF16_A, bb = bf16 & RG_BF16_B;
    const bool bh0 = bf16 & RG_BF16_H0;
    cudaStream_t st = (cudaStream_t)stream;
    if (ba && bb)
        rglru_scan_kernel<true, true><<<grid, RG_THREADS, 0, st>>>(
            a, b, h0, y, hout, L, D, h0_bs, bh0);
    else if (ba)
        rglru_scan_kernel<true, false><<<grid, RG_THREADS, 0, st>>>(
            a, b, h0, y, hout, L, D, h0_bs, bh0);
    else if (bb)
        rglru_scan_kernel<false, true><<<grid, RG_THREADS, 0, st>>>(
            a, b, h0, y, hout, L, D, h0_bs, bh0);
    else
        rglru_scan_kernel<false, false><<<grid, RG_THREADS, 0, st>>>(
            a, b, h0, y, hout, L, D, h0_bs, bh0);
    return (int)cudaGetLastError();
}
