// Device code of the selective-scan kernel: one block's channels of one
// sequence, walked over all L steps.  Included by mamba_scan.cu.  It uses
// only __syncthreads, __shfl_xor_sync, expf, the bit casts
// __float_as_uint/__uint_as_float and float2, so it also compiles on a host
// that defines them (threads and barriers: csrc/rehearse/), which is how it
// is checked without a card.
#pragma once

#include <stdint.h>

// From the generated constants header: the block size, the lanes (threads)
// of a channel, the chunk of steps staged at a time, the range of N, and
// one bit per input of the dtype mask (MS_BF16_X, _DT, _A, _B, _C, _D_SKIP,
// _H0: set = bf16, clear = float32; the outputs y and h_final take x's
// dtype).
#if !defined(MS_THREADS) || !defined(MS_LANES) || !defined(MS_CHUNK) || \
    !defined(MS_MIN_N) || !defined(MS_MAX_N) || !defined(MS_BF16_H0)
#error "MS_* come from the generated constants header"
#endif

// The raw bits of element i of a float32 or bf16 array.
__device__ __forceinline__ uint32_t ms_bits(const void *p, bool bf16,
                                            int64_t i) {
    return bf16 ? (uint32_t)((const uint16_t *)p)[i]
                : ((const uint32_t *)p)[i];
}

__device__ __forceinline__ float ms_widen(uint32_t bits, bool bf16) {
    return __uint_as_float(bf16 ? bits << 16 : bits);
}

__device__ __forceinline__ float ms_load(const void *p, bool bf16,
                                         int64_t i) {
    return ms_widen(ms_bits(p, bf16, i), bf16);
}

// float32 -> bf16 rounded to nearest even, NaN kept quiet (PyTorch's rule).
__device__ __forceinline__ void ms_store(void *p, bool bf16, int64_t i,
                                         float v) {
    if (!bf16) {
        ((float *)p)[i] = v;
        return;
    }
    const uint32_t u = __float_as_uint(v);
    const uint32_t r = (u & 0x7fffffffu) > 0x7f800000u
                           ? 0x7fc00000u
                           : u + 0x7fffu + ((u >> 16) & 1u);
    ((uint16_t *)p)[i] = (uint16_t)(r >> 16);
}

// The scan of sequence b over channels [d0, d0 + MS_THREADS / LPC) of D,
// LPC = MS_LANES.
//
// Thread tid owns channel c = tid / LPC and its S = N / LPC state elements
// n = g * S + s (g = tid % LPC): their h live in registers for all L steps,
// so dt_t * x_t is formed once per thread.  Each lane keeps its share of
// every y_t of a chunk in registers; after the chunk the LPC lanes of a
// channel sum them with a reduce-scatter of shuffles (MS_CHUNK * (1 - 1 /
// LPC) a lane, none on the steps' path) and each stores MS_CHUNK / LPC of
// them.  The recurrence of each state is one multiply-add a step, so a
// step's latency does not chain beyond it: a full chunk is straight-line
// code without a branch or a shuffle, and the scheduler overlaps its steps;
// what remains is the exps and multiply-adds themselves.
//
// Staging: chunks of MS_CHUNK steps of x and dt (as float2 pairs) and of B
// and C (also paired) sit in shared memory, double buffered.  While the
// block computes chunk k, each thread holds the raw bits of its share of
// chunk k + 1 in registers, loaded before chunk k's first step; they are
// widened and stored to the other buffer after chunk k's last step.  Full
// chunks run as straight-line code; only the last may be partial.
//
// Row-major layouts: x, dt, y (batch, L, D); B, C (batch, L, N); A and h0
// (., D, N) with batch strides a_bs and h0_bs (0: shared); D_skip (., D)
// with batch stride dsk_bs; h_final (batch, D, N).  h0 may be null (zeros).
// sxd: 2 * MS_CHUNK * (MS_THREADS / LPC) float2; sbc: 2 * MS_CHUNK * N.
template <int N>
__device__ __forceinline__ void ms_block(
    const void *__restrict__ x, const void *__restrict__ dt,
    const void *__restrict__ A, const void *__restrict__ B,
    const void *__restrict__ C, const void *__restrict__ Dsk,
    const void *__restrict__ h0, void *__restrict__ y,
    void *__restrict__ hout, int L, int D, int64_t a_bs, int64_t dsk_bs,
    int64_t h0_bs, unsigned bf16, int b, int d0, int tid,
    float2 *__restrict__ sxd, float2 *__restrict__ sbc) {
    constexpr int LPC = MS_LANES;
    constexpr int S = N / LPC;
    constexpr int CPB = MS_THREADS / LPC;         // channels of the block
    constexpr int XD = MS_CHUNK * CPB;            // x (or dt) of a chunk
    constexpr int BC = MS_CHUNK * N;              // B (or C) of a chunk
    constexpr int XPT = XD / MS_THREADS;          // ... staged by a thread
    constexpr int BPT = (BC + MS_THREADS - 1) / MS_THREADS;
    static_assert(N % LPC == 0 && 32 % LPC == 0 && XD % MS_THREADS == 0,
                  "lanes per channel must divide N and the warp");
    const int c = tid / LPC, g = tid % LPC;
    const int d = d0 + c;
    const bool live = d < D;
    const bool bx = bf16 & MS_BF16_X, bdt = bf16 & MS_BF16_DT;
    const bool bB = bf16 & MS_BF16_B, bC = bf16 & MS_BF16_C;
    const int64_t xrow = (int64_t)b * L * D;
    const int64_t brow = (int64_t)b * L * N;

    float a[S], h[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int64_t dn = (int64_t)d * N + g * S + s;
        a[s] = live ? ms_load(A, bf16 & MS_BF16_A, b * a_bs + dn) : 0.f;
        h[s] = (h0 != nullptr && live)
                   ? ms_load(h0, bf16 & MS_BF16_H0, b * h0_bs + dn) : 0.f;
    }
    const float dsk =
        live ? ms_load(Dsk, bf16 & MS_BF16_D_SKIP, b * dsk_bs + d) : 0.f;

    // this thread's share of one chunk, as raw bits: x/dt element e = tid +
    // i * MS_THREADS is (step e / CPB, channel e % CPB); B/C element e is
    // (step e / N, n e % N)
    uint32_t rx[XPT], rdt[XPT], rb[BPT], rc[BPT];
    auto fetch = [&](int t0) {
#pragma unroll
        for (int i = 0; i < XPT; ++i) {
            const int e = tid + i * MS_THREADS;
            const int t = t0 + e / CPB, dd = d0 + e % CPB;
            const int64_t off = xrow + (int64_t)t * D + dd;
            const bool in = t < L && dd < D;
            rx[i] = in ? ms_bits(x, bx, off) : 0u;
            rdt[i] = in ? ms_bits(dt, bdt, off) : 0u;
        }
#pragma unroll
        for (int i = 0; i < BPT; ++i) {
            const int e = tid + i * MS_THREADS;
            const bool in = e < BC && t0 + e / N < L;
            const int64_t off = brow + (int64_t)t0 * N + e;
            rb[i] = in ? ms_bits(B, bB, off) : 0u;
            rc[i] = in ? ms_bits(C, bC, off) : 0u;
        }
    };
    auto stash = [&](int buf) {
#pragma unroll
        for (int i = 0; i < XPT; ++i)
            sxd[buf * XD + tid + i * MS_THREADS] =
                float2{ms_widen(rx[i], bx), ms_widen(rdt[i], bdt)};
#pragma unroll
        for (int i = 0; i < BPT; ++i) {
            const int e = tid + i * MS_THREADS;
            if (e < BC)
                sbc[buf * BC + e] = float2{ms_widen(rb[i], bB),
                                           ms_widen(rc[i], bC)};
        }
    };

    fetch(0);
    stash(0);
    __syncthreads();
    for (int t0 = 0, buf = 0; t0 < L; t0 += MS_CHUNK, buf ^= 1) {
        const bool more = t0 + MS_CHUNK < L;
        if (more) fetch(t0 + MS_CHUNK);
        const float2 *xd = sxd + buf * XD;
        const float2 *bc = sbc + buf * BC;
        // one step: h updated in registers; returns this lane's share of
        // h_t . C_t (its S states).  No branch and no shuffle, so a full
        // chunk is one basic block whose steps the scheduler overlaps: the
        // only chain from step to step is each state's multiply-add.
        auto step = [&](int tt) {
            const float2 v = xd[tt * CPB + c];        // (x_t, dt_t)
            const float dtx = v.y * v.x;
            float p = 0.f;
#pragma unroll
            for (int s = 0; s < S; ++s) {
                const float2 q = bc[tt * N + g * S + s];  // (B_t, C_t)
                const float dA = expf(v.y * a[s]);
                h[s] = dA * h[s] + dtx * q.x;
                p += h[s] * q.y;
            }
            return p;
        };
        if (L - t0 >= MS_CHUNK) {
            float yv[MS_CHUNK];
#pragma unroll
            for (int tt = 0; tt < MS_CHUNK; ++tt) yv[tt] = step(tt);
            // sum the LPC lanes' shares, scattered: at each level a lane
            // keeps half of its steps and adds its partner's half of them,
            // so lane g ends with the whole sums of the MS_CHUNK / LPC steps
            // from g * MS_CHUNK / LPC
            int n = MS_CHUNK;
#pragma unroll
            for (int o = LPC >> 1; o > 0; o >>= 1) {
                n >>= 1;
                const bool upper = g & o;
#pragma unroll
                for (int i = 0; i < MS_CHUNK / 2; ++i) {
                    if (i >= n) break;
                    const float keep = upper ? yv[i + n] : yv[i];
                    const float give = upper ? yv[i] : yv[i + n];
                    yv[i] = keep + __shfl_xor_sync(0xffffffffu, give, o);
                }
            }
            if (live) {
                const int first = g * (MS_CHUNK / LPC);
#pragma unroll
                for (int i = 0; i < MS_CHUNK / LPC; ++i) {
                    const int tt = first + i;
                    ms_store(y, bx, xrow + (int64_t)(t0 + tt) * D + d,
                             yv[i] + dsk * xd[tt * CPB + c].x);
                }
            }
        } else {
#pragma unroll 1
            for (int tt = 0; tt < L - t0; ++tt) {
                float p = step(tt);
#pragma unroll
                for (int o = LPC >> 1; o > 0; o >>= 1)
                    p += __shfl_xor_sync(0xffffffffu, p, o);
                if (g == 0 && live)
                    ms_store(y, bx, xrow + (int64_t)(t0 + tt) * D + d,
                             p + dsk * xd[tt * CPB + c].x);
            }
        }
        if (more) stash(buf ^ 1);
        __syncthreads();
    }
    if (live) {
#pragma unroll
        for (int s = 0; s < S; ++s)
            ms_store(hout, bx, ((int64_t)b * D + d) * N + g * S + s, h[s]);
    }
}
