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
// sequential dimension is a loop inside the block: one thread per
// (sequence, channel, state element) keeps its h in a register for all L
// steps; a block of MS_THREADS threads holds MS_THREADS / N channels, and
// the grid is (channel blocks, sequences).  Chunks of MS_CHUNK steps of x,
// dt, B and C are staged in shared memory; y_t is reduced over a
// channel's N lanes with warp shuffles.  Nothing is padded: the last
// channel block and the last chunk are masked.
//
// What bounds it on this card: bytes, 2 per bf16 element of x, dt, y
// (L x D each), A, h_final (D x N), B, C (L x N) over 3.35 TB/s; the
// operations (seven per (t, d, n), one of them an exp) are of the same
// order over the 32-bit rate.  For one 256-token prefill of
// falcon-mamba-7b (D 8,192, N 16) that is about 4 microseconds.  This
// simple design is bound instead by the serial chain of L steps per thread
// (a shared-memory read, an exp, a multiply-add and log2(N) shuffles each)
// and by 16-byte row segments of x and dt per block; more channels per
// warp, cp.async/TMA staging and fusing the conv, softplus and gate around
// it are later work.
//
// Built by repro_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain C shared library, loaded with ctypes; the constants header it
// includes (MS_THREADS, MS_CHUNK, MS_MIN_N, MS_MAX_N) is generated from
// repro_torch/kernels/mamba_scan/kernel.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mamba_scan_kernel.cuh"

__global__ void __launch_bounds__(MS_THREADS)
mamba_scan_kernel(const void *x, const void *dt, const void *A,
                  const void *B, const void *C, const void *Dsk,
                  const void *h0, void *y, void *hout, int L, int D, int N,
                  int64_t a_bs, int64_t dsk_bs, int64_t h0_bs,
                  unsigned bf16) {
    __shared__ float sx[MS_CHUNK * MS_MAX_CH];
    __shared__ float sdt[MS_CHUNK * MS_MAX_CH];
    __shared__ float sB[MS_CHUNK * MS_MAX_N];
    __shared__ float sC[MS_CHUNK * MS_MAX_N];
    ms_block(x, dt, A, B, C, Dsk, h0, y, hout, L, D, N, a_bs, dsk_bs, h0_bs,
             bf16, blockIdx.y, blockIdx.x * (MS_THREADS / N), threadIdx.x,
             sx, sdt, sB, sC);
}

// Scan `batch` sequences of L steps over D channels with state size N (a
// power of two in [MS_MIN_N, MS_MAX_N]) on `stream`.  Returns the CUDA
// error of the launch (0 = launched); it does not synchronise.
extern "C" int mamba_scan_run(const void *x, const void *dt, const void *A,
                              const void *B, const void *C, const void *Dsk,
                              const void *h0, void *y, void *hout, int batch,
                              int L, int D, int N, int64_t a_bs,
                              int64_t dsk_bs, int64_t h0_bs, unsigned bf16,
                              void *stream) {
    if (batch < 1 || batch > 65535 || L < 1 || D < 1 || N < MS_MIN_N ||
        N > MS_MAX_N || (N & (N - 1)) != 0)
        return (int)cudaErrorInvalidValue;
    const int ch = MS_THREADS / N;
    const dim3 grid((unsigned)((D + ch - 1) / ch), (unsigned)batch);
    mamba_scan_kernel<<<grid, MS_THREADS, 0, (cudaStream_t)stream>>>(
        x, dt, A, B, C, Dsk, h0, y, hout, L, D, N, a_bs, dsk_bs, h0_bs,
        bf16);
    return (int)cudaGetLastError();
}
