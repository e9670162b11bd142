// Selective-scan kernel for Hopper (sm_90a): the Mamba-1 recurrence
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,
//   y_t = h_t . C_t + D_skip * x_t
// over a batch of sequences, h and all arithmetic in float32 (expf, built
// without --use_fast_math), inputs read as float32 or bf16 each, y and
// h_final written in x's dtype.
//
// Replaces the Pallas kernel _scan_kernel
// (src/repro/kernels/mamba_scan/kernel.py, wrapper selective_scan_pallas,
// pl.pallas_call at line 94) and keeps its contract, not its grid.  On the
// TPU the grid tiled D by 128 lanes and walked L in sequential chunks,
// carrying h in VMEM from grid step to grid step, with x, dt, B and C
// padded to whole tiles.  Blocks on Hopper run in no order, so here the
// sequential dimension is a loop inside the block, and h stays in
// registers for all L steps.  Nothing is padded: the last channel block
// and the last chunk are masked.
//
// What bounds it on this card.  Bytes: 2 per bf16 element of x, dt, y
// (L x D each), A, h_final (D x N), B, C (L x N) over 3.35 TB/s, about 4
// microseconds for one 256-token prefill of falcon-mamba-7b (D 8,192,
// N 16).  But the work is L x D x N exponentials and multiply-adds, and
// they set the real floor: 33.5 M expf at that shape are 8 microseconds on
// the SFU alone (16 a clock an SM), and each expf (without fast math) is
// about eight instructions, some 11 microseconds of issue at the card's
// 32-bit rate.  The first design (one thread per channel and state
// element) took 0.144 ms there, 37x the bytes bound: every one of a
// channel's 16 lanes re-read x_t and dt_t and re-formed dt * x, y_t took a
// four-step shuffle chain and a branch each step, and its staging loads
// were consumed as they landed.  This design gives each thread S = N / LPC
// states of one channel (LPC lanes a channel, ms_block), so a step is S
// exps and multiply-adds in registers, one shared load of (x_t, dt_t) and S
// of (B_t, C_t), with no branch and no shuffle: y_t's shares are summed
// after each chunk by a reduce-scatter of shuffles; the next chunk's inputs
// are loaded before the current one is computed.  LPC (MS_LANES) is 4:
// more lanes a channel mean more warps to hide latency, fewer mean less
// repeated work a step, and of 2, 4 and 8 lanes, 4 was the fastest at
// falcon-mamba-7b's prefill on the H100 (PERF.md).
//
// Built by repro_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain C shared library, loaded with ctypes; the constants header it
// includes (MS_THREADS, MS_LANES, MS_CHUNK, MS_MIN_N, MS_MAX_N, the dtype
// bits) is generated from repro_torch/kernels/mamba_scan/kernel.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mamba_scan_kernel.cuh"

template <int N>
__global__ void __launch_bounds__(MS_THREADS)
mamba_scan_kernel(const void *x, const void *dt, const void *A,
                  const void *B, const void *C, const void *Dsk,
                  const void *h0, void *y, void *hout, int L, int D,
                  int64_t a_bs, int64_t dsk_bs, int64_t h0_bs,
                  unsigned bf16) {
    __shared__ float2 sxd[2 * MS_CHUNK * (MS_THREADS / MS_LANES)];
    __shared__ float2 sbc[2 * MS_CHUNK * N];
    ms_block<N>(x, dt, A, B, C, Dsk, h0, y, hout, L, D, a_bs, dsk_bs, h0_bs,
                bf16, blockIdx.y, blockIdx.x * (MS_THREADS / MS_LANES),
                threadIdx.x, sxd, sbc);
}

template <int N>
static int ms_launch(const void *x, const void *dt, const void *A,
                     const void *B, const void *C, const void *Dsk,
                     const void *h0, void *y, void *hout, int batch, int L,
                     int D, int64_t a_bs, int64_t dsk_bs, int64_t h0_bs,
                     unsigned bf16, cudaStream_t stream) {
    constexpr int ch = MS_THREADS / MS_LANES;
    const dim3 grid((unsigned)((D + ch - 1) / ch), (unsigned)batch);
    mamba_scan_kernel<N><<<grid, MS_THREADS, 0, stream>>>(
        x, dt, A, B, C, Dsk, h0, y, hout, L, D, a_bs, dsk_bs, h0_bs, bf16);
    return (int)cudaGetLastError();
}

// Scan `batch` sequences of L steps over D channels with state size N (4,
// 8 or 16) on `stream`.  Returns the CUDA error of the launch (0 =
// launched); it does not synchronise.
extern "C" int mamba_scan_run(const void *x, const void *dt, const void *A,
                              const void *B, const void *C, const void *Dsk,
                              const void *h0, void *y, void *hout, int batch,
                              int L, int D, int N, int64_t a_bs,
                              int64_t dsk_bs, int64_t h0_bs, unsigned bf16,
                              void *stream) {
    static_assert(MS_MIN_N == 4 && MS_MAX_N == 16, "one kernel per N");
    if (batch < 1 || batch > 65535 || L < 1 || D < 1)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (N) {
    case 4:
        return ms_launch<4>(x, dt, A, B, C, Dsk, h0, y, hout, batch, L, D,
                            a_bs, dsk_bs, h0_bs, bf16, st);
    case 8:
        return ms_launch<8>(x, dt, A, B, C, Dsk, h0, y, hout, batch, L, D,
                            a_bs, dsk_bs, h0_bs, bf16, st);
    case 16:
        return ms_launch<16>(x, dt, A, B, C, Dsk, h0, y, hout, batch, L, D,
                             a_bs, dsk_bs, h0_bs, bf16, st);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
