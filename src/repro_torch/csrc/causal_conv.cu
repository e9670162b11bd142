// Causal depthwise conv kernel for Hopper (sm_90a): the Mamba-1 mixer's
// conv over its in-projection's x half, with the conv's bias and the SiLU
// after it,
//   y[b, t, c] = silu(sum_k w[c, k] * xpad[b, t + k, c] + bias[c]),
// xpad being x with KW-1 zero rows in front, and the conv's tail, the last
// KW-1 rows of xpad (the decode state), in one pass.  float32 or bf16; the
// conv's sum in float32, rounded at the points where the plain PyTorch
// version (kernels/causal_conv/ref.py) rounds.
//
// It replaces no TPU kernel: the reference's conv is plain XLA (a stack of
// shifted views and an einsum in repro/models/layers.py), and so was the
// port's, which built four shifted copies of the input with torch.stack,
// copied them again for a batched GEMV over the channels and ran the bias
// and the SiLU as two more passes: about 1.1 ms a layer at a 2,050-token
// prompt of falcon-mamba-7b (PERF.md).
//
// What bounds it on this card.  Bytes: it reads x once and writes y once,
// 2 x S x d_inner bf16 (67 MB at S 2,048, d_inner 8,192: 20 microseconds at
// 3.35 TB/s); its 4 multiply-adds per element are far below the card's
// rates.  So the design is a stream that keeps HBM busy: each thread owns
// CC_CHANNELS consecutive channels and walks a run of positions in order,
// keeping the window's last KW-1 rows in registers, so that each input
// byte comes from HBM once (plus a halo of KW-1 rows a run, which the run
// before has just brought into L2); it keeps CC_UNROLL rows in flight
// ahead of the one it computes; the KW weights and the bias of its
// channels stay in registers.  The run length is chosen by the caller from
// the batch, S and d_inner (kernels/causal_conv/kernel.py:run_length):
// long enough that the halo costs little, short enough that a short
// prompt still gives every SM threads to keep its loads in flight.  x is
// the chunk view of the in-projection's product, read in place through its
// row stride, never copied.  TMA and shared memory add nothing to a
// one-pass stream in which no byte is used by two threads, so the kernel
// uses neither: a ring of rows in shared memory fed by cp.async, 2 to 12
// rows in flight without holding registers, ran within 3% of this one.
//
// What it was tuned against (PERF.md, on one H100): the same walk with the
// arithmetic taken out moves the bytes at 77% of the bound at S 2,048 and
// 88% at 10,857; the SiLU's exponential and division, computed exactly as
// PyTorch does (about 20 instructions an element), add what the loads do
// not hide.  So registers, not bytes, set the rows in flight: 4 channels
// a thread (8-byte loads, a warp's row 256 contiguous bytes) need 47-72
// registers to 8 channels' 71-122, and let 1.5-2x the threads hide the
// loads, and 2 rows in flight beat 1, 3 and 4.  An approximate exponential
// and division, with the exact SiLU where the result lies near a bf16
// rounding boundary, matched PyTorch on every bf16 value but ran slower:
// its branch diverges in most warps.
//
// Built by repro_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain C shared library, loaded with ctypes; the constants header it
// includes (CC_THREADS, CC_CHANNELS, CC_UNROLL, CC_MIN_WIDTH, CC_MAX_WIDTH,
// the flag bits) is generated from repro_torch/kernels/causal_conv/kernel.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "causal_conv_kernel.cuh"

template <int KW, bool BF16>
__global__ void __launch_bounds__(CC_THREADS)
causal_conv_kernel(const void *x, const void *w, const void *bias, void *y,
                   void *tail, int S, int d, int64_t sb, int64_t sr, int run,
                   unsigned flags) {
    cc_thread<KW, BF16>(x, w, bias, y, tail, S, d, sb, sr, run, flags,
                        blockIdx.z, blockIdx.x * CC_THREADS + threadIdx.x,
                        blockIdx.y);
}

template <int KW>
static int cc_launch(const void *x, const void *w, const void *bias, void *y,
                     void *tail, int batch, int S, int d, int64_t sb,
                     int64_t sr, int run, unsigned flags,
                     cudaStream_t stream) {
    const int groups = (d + CC_CHANNELS - 1) / CC_CHANNELS;
    const dim3 grid((unsigned)((groups + CC_THREADS - 1) / CC_THREADS),
                    (unsigned)((S + run - 1) / run), (unsigned)batch);
    if (flags & CC_FLAG_BF16)
        causal_conv_kernel<KW, true><<<grid, CC_THREADS, 0, stream>>>(
            x, w, bias, y, tail, S, d, sb, sr, run, flags);
    else
        causal_conv_kernel<KW, false><<<grid, CC_THREADS, 0, stream>>>(
            x, w, bias, y, tail, S, d, sb, sr, run, flags);
    return (int)cudaGetLastError();
}

// The conv of `batch` sequences of S positions over d channels, width kw
// (2, 3 or 4), each thread walking `run` positions, on `stream`.  Returns
// the CUDA error of the launch (0 = launched); it does not synchronise.
extern "C" int causal_conv_run(const void *x, const void *w, const void *bias,
                               void *y, void *tail, int batch, int S, int d,
                               int kw, int64_t sb, int64_t sr, int run,
                               unsigned flags, void *stream) {
    static_assert(CC_MIN_WIDTH == 2 && CC_MAX_WIDTH == 4,
                  "one kernel a width");
    if (batch < 1 || batch > 65535 || S < 1 || d < 1 || run < 1 ||
        (S + (int64_t)run - 1) / run > 65535)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (kw) {
    case 2:
        return cc_launch<2>(x, w, bias, y, tail, batch, S, d, sb, sr, run,
                            flags, st);
    case 3:
        return cc_launch<3>(x, w, bias, y, tail, batch, S, d, sb, sr, run,
                            flags, st);
    case 4:
        return cc_launch<4>(x, w, bias, y, tail, batch, S, d, sb, sr, run,
                            flags, st);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
