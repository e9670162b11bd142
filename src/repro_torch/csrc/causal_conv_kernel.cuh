// Device code of the causal depthwise conv kernel: one thread's channels of
// one run of positions of one sequence.  Included by causal_conv.cu.  It
// uses only expf, fmaf, the bit casts __float_as_uint/__uint_as_float,
// uint4 and, on the card, the cvt.rn.bf16x2.f32 instruction (on a host, the
// same rounding written out), so it also compiles on a host that defines
// them (csrc/rehearse/), which is how it is checked without a card.
#pragma once

#include <stdint.h>

// From the generated constants header: the block size, the channels of a
// thread, the rows loaded ahead, the range of widths, and the bits of the
// flags word (CC_FLAG_BF16: x, w, b and the outputs are bf16, else
// float32; CC_FLAG_VEC_X, _VEC_P, _VEC_Y: x's rows, the parameters, the
// outputs' rows start on 16-byte boundaries, so a thread's channels move as
// whole 8- or 16-byte words).
#if !defined(CC_THREADS) || !defined(CC_CHANNELS) || !defined(CC_UNROLL) || \
    !defined(CC_MIN_WIDTH) || !defined(CC_MAX_WIDTH) ||                    \
    !defined(CC_FLAG_BF16) || !defined(CC_FLAG_VEC_X) ||                   \
    !defined(CC_FLAG_VEC_P) || !defined(CC_FLAG_VEC_Y)
#error "CC_* come from the generated constants header"
#endif

static_assert(CC_CHANNELS == 4 || CC_CHANNELS == 8,
              "a thread's channels are 8 or 16 bytes of bf16");

// A thread's channels of one row as the dtype's raw 32-bit words (bf16:
// channel 2h in the low half of word h).
template <bool BF16>
struct CcRow {
    static constexpr int W = BF16 ? CC_CHANNELS / 2 : CC_CHANNELS;
    uint32_t w[W];
};

// The row at p + i: with vec, p + i lies on a boundary of its size (8 or
// 16 bytes, or a 16-byte one for 32 bytes) and the row is read as whole
// words; else one element at a time, those at or past `valid` read as 0.
// Without `have` (the pad, or past the run), zeros.
template <bool BF16>
__device__ __forceinline__ CcRow<BF16> cc_fetch(const void *__restrict__ p,
                                                bool vec, int64_t i,
                                                int valid, bool have) {
    constexpr int W = CcRow<BF16>::W;
    CcRow<BF16> r;
    const char *at = (const char *)p + i * (BF16 ? 2 : 4);
    if (have && vec) {
        if constexpr (W == 2) {
            const uint2 v = *(const uint2 *)at;
            r.w[0] = v.x;
            r.w[1] = v.y;
        } else {
#pragma unroll
            for (int j = 0; j < W / 4; ++j) {
                const uint4 v = ((const uint4 *)at)[j];
                r.w[4 * j] = v.x;
                r.w[4 * j + 1] = v.y;
                r.w[4 * j + 2] = v.z;
                r.w[4 * j + 3] = v.w;
            }
        }
        return r;
    }
#pragma unroll
    for (int j = 0; j < W; ++j) r.w[j] = 0u;
    if (have) {
#pragma unroll
        for (int e = 0; e < CC_CHANNELS; ++e) {
            if (e >= valid) break;
            if constexpr (BF16)
                r.w[e >> 1] |= (uint32_t)((const uint16_t *)p)[i + e]
                               << (16 * (e & 1));
            else
                r.w[e] = ((const uint32_t *)p)[i + e];
        }
    }
    return r;
}

// The row's 8 values, widened to float32.
template <bool BF16>
__device__ __forceinline__ void cc_widen(const CcRow<BF16> &r,
                                         float (&v)[CC_CHANNELS]) {
#pragma unroll
    for (int e = 0; e < CC_CHANNELS; ++e) {
        if constexpr (BF16)
            v[e] = __uint_as_float(e & 1 ? r.w[e >> 1] & 0xffff0000u
                                         : r.w[e >> 1] << 16);
        else
            v[e] = __uint_as_float(r.w[e]);
    }
}

// Store the row at p + i: whole words with vec, else its first `valid`
// elements one at a time.
template <bool BF16>
__device__ __forceinline__ void cc_put(void *__restrict__ p, bool vec,
                                       int64_t i, int valid,
                                       const CcRow<BF16> &r) {
    constexpr int W = CcRow<BF16>::W;
    char *at = (char *)p + i * (BF16 ? 2 : 4);
    if (vec) {
        if constexpr (W == 2) {
            *(uint2 *)at = uint2{r.w[0], r.w[1]};
        } else {
#pragma unroll
            for (int j = 0; j < W / 4; ++j)
                ((uint4 *)at)[j] = uint4{r.w[4 * j], r.w[4 * j + 1],
                                         r.w[4 * j + 2], r.w[4 * j + 3]};
        }
        return;
    }
#pragma unroll
    for (int e = 0; e < CC_CHANNELS; ++e) {
        if (e >= valid) break;
        if constexpr (BF16)
            ((uint16_t *)p)[i + e] =
                (uint16_t)(r.w[e >> 1] >> (16 * (e & 1)));
        else
            ((uint32_t *)p)[i + e] = r.w[e];
    }
}

// a and b rounded to bf16, nearest even, packed: a in the low half.  On
// the card one cvt.rn.bf16x2.f32, the instruction PyTorch's casts use; on
// a host the same rounding written out (a NaN becomes the quiet 0x7fc0).
__device__ __forceinline__ uint32_t cc_bf16x2(float a, float b) {
#ifdef __CUDA_ARCH__
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(b), "f"(a));
    return d;
#else
    auto rne = [](float f) {
        const uint32_t u = __float_as_uint(f);
        return (u & 0x7fffffffu) > 0x7f800000u
                   ? 0x7fc0u
                   : (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
    };
    return rne(a) | rne(b) << 16;
#endif
}

// v[2h], v[2h+1] rounded to bf16 in place (widened back to float32).
__device__ __forceinline__ void cc_round(float (&v)[CC_CHANNELS]) {
#pragma unroll
    for (int h = 0; h < CC_CHANNELS / 2; ++h) {
        const uint32_t p = cc_bf16x2(v[2 * h], v[2 * h + 1]);
        v[2 * h] = __uint_as_float(p << 16);
        v[2 * h + 1] = __uint_as_float(p & 0xffff0000u);
    }
}

// PyTorch's SiLU in float32, v / (1 + expf(-v)), the exponential and the
// division as nvcc builds them without fast math.
__device__ __forceinline__ float cc_silu(float v) {
    return v / (1.f + expf(-v));
}

// silu(conv(x) + b) over channels [g * CH, g * CH + CH) of sequence b, at the
// positions [r * run, min(S, r * run + run)), in float32 or (BF16) bf16:
// the conv's KW-term sum in float32 over k = 0 .. KW-1 (fmaf, from 0),
// rounded to the dtype; + b, rounded; SiLU as v / (1 + expf(-v)) in
// float32 (cc_silu), rounded, as PyTorch computes each step.
//
// The thread keeps the window's last KW-1 input rows in registers and walks
// its run in order with the next CC_UNROLL rows in flight: as it takes a row
// it asks for the one CC_UNROLL rows on, so each thread always has that
// many loads outstanding.  Each row of x is read once, and a run's first KW-1
// rows' window (its halo, the pad's zeros before position 0) once more by
// the run before.  The thread whose run ends at S also writes the tail, the
// last KW-1 rows of the padded input, read again from x.  The weights (KW
// per channel) and biases stay in registers.
//
// Layouts: x (batch, S, d) with batch stride sb and row stride sr
// (elements; the channels contiguous); w (d, KW) and b (d,) contiguous; y
// (batch, S, d) and tail (batch, KW-1, d) contiguous.
template <int KW, bool BF16>
__device__ __forceinline__ void cc_thread(
    const void *__restrict__ x, const void *__restrict__ w,
    const void *__restrict__ bias, void *__restrict__ y,
    void *__restrict__ tail, int S, int d, int64_t sb, int64_t sr, int run,
    unsigned flags, int b, int g, int r) {
    constexpr int CH = CC_CHANNELS;
    constexpr int U = CC_UNROLL;
    static_assert(KW >= CC_MIN_WIDTH && KW <= CC_MAX_WIDTH && KW >= 2,
                  "one kernel per width");
    const int c = g * CH;
    if (c >= d) return;
    const int nc = d - c < CH ? d - c : CH;
    const bool full = nc == CH;
    const bool vx = full && (flags & CC_FLAG_VEC_X);
    const bool vp = full && (flags & CC_FLAG_VEC_P);
    const bool vy = full && (flags & CC_FLAG_VEC_Y);

    // the weights, KW rows of the thread's (d, KW) block, and the biases
    float wt[CH * KW], bb[CH];
#pragma unroll
    for (int k = 0; k < KW; ++k) {
        float v[CH];
        cc_widen(cc_fetch<BF16>(w, vp, (int64_t)c * KW + k * CH,
                                nc * KW - k * CH, true), v);
#pragma unroll
        for (int e = 0; e < CH; ++e) wt[k * CH + e] = v[e];
    }
    cc_widen(cc_fetch<BF16>(bias, vp, c, nc, true), bb);
    const int64_t xb = (int64_t)b * sb + c;
    const int t0 = r * run;
    const int t1 = S - t0 < run ? S : t0 + run;

    // win[k] is row t - (KW-1) + k of the padded input; rows before
    // position 0 are the pad's zeros
    float win[KW][CH];
#pragma unroll
    for (int k = 0; k < KW - 1; ++k) {
        const int row = t0 - (KW - 1) + k;
        cc_widen(cc_fetch<BF16>(x, vx, xb + row * sr, nc, row >= 0),
                 win[k]);
    }
    // a ring of the next U rows, in flight while the current one is
    // computed: row t + u sits in ring[u] until it is taken, and row
    // t + U + u is asked for in its place
    CcRow<BF16> ring[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
        ring[u] = cc_fetch<BF16>(x, vx, xb + (t0 + u) * sr, nc, t0 + u < t1);
    for (int t = t0; t < t1; t += U) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            cc_widen(ring[u], win[KW - 1]);
            const int ahead = t + U + u;
            ring[u] = cc_fetch<BF16>(x, vx, xb + ahead * sr, nc, ahead < t1);
            float v[CH];
#pragma unroll
            for (int i = 0; i < CH; ++i) {
                // the flat weights hold channel i's KW taps at i*KW .. +KW-1
                float acc = 0.f;
#pragma unroll
                for (int k = 0; k < KW; ++k)
                    acc = fmaf(win[k][i], wt[i * KW + k], acc);
                v[i] = acc;
            }
            if constexpr (BF16) cc_round(v);
#pragma unroll
            for (int i = 0; i < CH; ++i) v[i] += bb[i];
            if constexpr (BF16) cc_round(v);
            CcRow<BF16> out;
#pragma unroll
            for (int h = 0; h < CH / 2; ++h) {
                if constexpr (BF16) {
                    out.w[h] = cc_bf16x2(cc_silu(v[2 * h]),
                                         cc_silu(v[2 * h + 1]));
                } else {
                    out.w[2 * h] = __float_as_uint(cc_silu(v[2 * h]));
                    out.w[2 * h + 1] = __float_as_uint(cc_silu(v[2 * h + 1]));
                }
            }
            if (t + u < t1)
                cc_put<BF16>(y, vy, ((int64_t)b * S + t + u) * d + c, nc,
                             out);
#pragma unroll
            for (int k = 0; k < KW - 1; ++k)
#pragma unroll
                for (int i = 0; i < CH; ++i) win[k][i] = win[k + 1][i];
        }
    }
    if (t1 == S) {
#pragma unroll
        for (int k = 0; k < KW - 1; ++k) {
            const int row = S - (KW - 1) + k;
            cc_put<BF16>(tail, vy, ((int64_t)b * (KW - 1) + k) * d + c, nc,
                         cc_fetch<BF16>(x, vx, xb + row * sr, nc, row >= 0));
        }
    }
}
