// Device code of the selective-scan kernel: one block's channels of one
// sequence, walked over all L steps.  Included by mamba_scan.cu.  It uses
// only __syncthreads, __shfl_xor_sync, expf and the bit casts
// __float_as_uint/__uint_as_float, so it can be compiled on a host with
// those defined (threads and barriers) to check it without a card.
#pragma once

#include <stdint.h>

// From the generated constants header: the block size, the chunk of steps
// staged at a time, the range of N, and one bit per input of the dtype
// mask (MS_BF16_X, _DT, _A, _B, _C, _D_SKIP, _H0: set = bf16, clear =
// float32; the outputs y and h_final take x's dtype).
#if !defined(MS_THREADS) || !defined(MS_CHUNK) || !defined(MS_MIN_N) || \
    !defined(MS_MAX_N) || !defined(MS_BF16_H0)
#error "MS_* come from the generated constants header"
#endif
// channels of one block at the smallest N (one thread per (channel, n))
#define MS_MAX_CH (MS_THREADS / MS_MIN_N)

__device__ __forceinline__ float ms_load(const void *p, bool bf16,
                                         int64_t i) {
    if (bf16)
        return __uint_as_float(
            (uint32_t)((const uint16_t *)p)[i] << 16);
    return ((const float *)p)[i];
}

// float32 -> bf16 rounded to nearest even, NaN kept quiet (PyTorch's rule).
__device__ __forceinline__ void ms_store(void *p, bool bf16, int64_t i,
                                         float v) {
    if (!bf16) {
        ((float *)p)[i] = v;
        return;
    }
    uint32_t u = __float_as_uint(v);
    if ((u & 0x7fffffffu) > 0x7f800000u)
        u = 0x7fc00000u;
    else
        u += 0x7fffu + ((u >> 16) & 1u);
    ((uint16_t *)p)[i] = (uint16_t)(u >> 16);
}

// The scan of sequence b over channels [d0, d0 + MS_THREADS / N) of D.
// Thread tid owns channel c = tid / N and state element n = tid % N; its
// h lives in a register for all L steps.  Row-major layouts: x, dt, y
// (batch, L, D); B, C (batch, L, N); A and h0 (., D, N) with batch
// strides a_bs and h0_bs (0: shared); D_skip (., D) with batch stride
// dsk_bs; h_final (batch, D, N).  h0 may be null (zeros).  Chunks of
// MS_CHUNK steps of x, dt, B and C are staged in shared memory as float32
// (sx, sdt: MS_CHUNK * MS_MAX_CH; sB, sC: MS_CHUNK * MS_MAX_N), so their
// loads are issued together, not one step at a time behind the
// recurrence.  y_t sums h * C_t over the N lanes of a channel with a
// butterfly of __shfl_xor_sync (N divides 32, so a channel's lanes share a
// warp); lane n = 0 adds D_skip * x_t and stores it.
__device__ __forceinline__ void ms_block(
    const void *x, const void *dt, const void *A, const void *B,
    const void *C, const void *Dsk, const void *h0, void *y, void *hout,
    int L, int D, int N, int64_t a_bs, int64_t dsk_bs, int64_t h0_bs,
    unsigned bf16, int b, int d0, int tid, float *sx, float *sdt,
    float *sB, float *sC) {
    const int ch = MS_THREADS / N;
    const int c = tid / N, n = tid % N;
    const int d = d0 + c;
    const bool live = d < D;
    const bool bx = bf16 & MS_BF16_X, bdt = bf16 & MS_BF16_DT;
    const bool bB = bf16 & MS_BF16_B, bC = bf16 & MS_BF16_C;
    const float a = live ? ms_load(A, bf16 & MS_BF16_A,
                                   b * a_bs + (int64_t)d * N + n) : 0.f;
    const float dsk = live ? ms_load(Dsk, bf16 & MS_BF16_D_SKIP,
                                     b * dsk_bs + d) : 0.f;
    float h = (h0 != nullptr && live)
                  ? ms_load(h0, bf16 & MS_BF16_H0,
                            b * h0_bs + (int64_t)d * N + n)
                  : 0.f;
    const int64_t xrow = (int64_t)b * L * D;
    const int64_t brow = (int64_t)b * L * N;
    for (int t0 = 0; t0 < L; t0 += MS_CHUNK) {
        const int nt = L - t0 < MS_CHUNK ? L - t0 : MS_CHUNK;
        __syncthreads();                 // the last chunk is read
        for (int i = tid; i < nt * ch; i += MS_THREADS) {
            const int tt = i / ch, dd = d0 + i % ch;
            const int64_t off = xrow + (int64_t)(t0 + tt) * D + dd;
            sx[i] = dd < D ? ms_load(x, bx, off) : 0.f;
            sdt[i] = dd < D ? ms_load(dt, bdt, off) : 0.f;
        }
        for (int i = tid; i < nt * N; i += MS_THREADS) {
            const int64_t off = brow + (int64_t)t0 * N + i;
            sB[i] = ms_load(B, bB, off);
            sC[i] = ms_load(C, bC, off);
        }
        __syncthreads();
        for (int tt = 0; tt < nt; ++tt) {
            const float xt = sx[tt * ch + c], dtt = sdt[tt * ch + c];
            const float dA = expf(dtt * a);
            const float dBx = (dtt * xt) * sB[tt * N + n];
            h = dA * h + dBx;
            float p = h * sC[tt * N + n];
            for (int off = N >> 1; off > 0; off >>= 1)
                p += __shfl_xor_sync(0xffffffffu, p, off);
            if (n == 0 && live)
                ms_store(y, bx, xrow + (int64_t)(t0 + tt) * D + d,
                         p + dsk * xt);
        }
    }
    if (live)
        ms_store(hout, bx, ((int64_t)b * D + d) * N + n, h);
}
