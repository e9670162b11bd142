// Device code of the RG-LRU scan kernel: one channel of one sequence,
// walked over all L steps.  Included by rglru_scan.cu.  It uses no
// synchronisation and no intrinsic beyond __fmul_rn, __fadd_rn and the bit
// casts __float_as_uint/__uint_as_float, so it can be compiled on a host
// with those defined, one loop iteration per thread, to check it without a
// card.
#pragma once

#include <stdint.h>

// From the generated constants header: the block size, the steps of a and
// b a thread loads at a time, and one bit per input of the dtype mask
// (RG_BF16_A, _B, _H0: set = bf16, clear = float32; the outputs y and
// h_final take a's dtype).
#if !defined(RG_THREADS) || !defined(RG_CHUNK) || !defined(RG_BF16_A) || \
    !defined(RG_BF16_B) || !defined(RG_BF16_H0)
#error "RG_* come from the generated constants header"
#endif

// The raw bits of element i: a bf16 in the low 16 bits, or a float32.
template <bool BF16>
__device__ __forceinline__ uint32_t rg_raw(const void *p, int64_t i) {
    if (BF16)
        return ((const uint16_t *)p)[i];
    return ((const uint32_t *)p)[i];
}

// The float32 value of raw bits from rg_raw.
template <bool BF16>
__device__ __forceinline__ float rg_value(uint32_t raw) {
    return __uint_as_float(BF16 ? raw << 16 : raw);
}

// float32 -> bf16 rounded to nearest even, NaN kept quiet (PyTorch's rule).
template <bool BF16>
__device__ __forceinline__ void rg_store(void *p, int64_t i, float v) {
    if (!BF16) {
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

// One chunk of steps [t0, t0 + RG_CHUNK) of one channel from state h
// (only those below L when TAIL): returns the new state.  Every load of
// the chunk's a and b is issued, into registers ra and rb (fully
// unrolled), before the first of them is used, and the loaded bits stay
// raw until the step that uses them, so the serial chain waits on memory
// once a chunk, not once a step: an instruction that reads a loaded
// register stalls until the load is back (widening a bf16 to float as it
// is loaded made every step wait a round trip).  A full chunk is straight-
// line code, so one step's rounding and store overlap the next step's
// multiply and add; a test per step would make each step a block of its
// own.  The product and the sum are rounded separately (no fused
// multiply-add), as the plain loop rounds them: on float32 inputs the two
// agree bit for bit.
template <bool BA, bool BB, bool TAIL>
__device__ __forceinline__ float rg_chunk(const void *a, const void *b,
                                          void *y, int64_t base, int t0,
                                          int L, int D, float h) {
    uint32_t ra[RG_CHUNK], rb[RG_CHUNK];
#pragma unroll
    for (int k = 0; k < RG_CHUNK; ++k) {
        if (!TAIL || t0 + k < L) {
            ra[k] = rg_raw<BA>(a, base + (int64_t)(t0 + k) * D);
            rb[k] = rg_raw<BB>(b, base + (int64_t)(t0 + k) * D);
        }
    }
#pragma unroll
    for (int k = 0; k < RG_CHUNK; ++k) {
        if (!TAIL || t0 + k < L) {
            h = __fadd_rn(__fmul_rn(rg_value<BA>(ra[k]), h),
                          rg_value<BB>(rb[k]));
            rg_store<BA>(y, base + (int64_t)(t0 + k) * D, h);
        }
    }
    return h;
}

// The scan of channel d of sequence s: h_t = a_t * h_{t-1} + b_t for t in
// [0, L), h from h0 (null: zeros) and kept in a float32 register, y_t
// written at every step, in chunks of RG_CHUNK steps (rg_chunk).
// Row-major layouts: a, b, y (batch, L, D); h0 (., D) with batch stride
// h0_bs (0: shared); h_final (batch, D).  BA and BB say whether a and b
// are bf16; y and h_final take a's dtype.  Neighbouring threads are
// neighbouring channels: each step's loads and stores are coalesced across
// the block.
template <bool BA, bool BB>
__device__ __forceinline__ void rg_channel(const void *a, const void *b,
                                           const void *h0, void *y,
                                           void *hout, int L, int D,
                                           int64_t h0_bs, bool bh0, int s,
                                           int d) {
    if (d >= D)
        return;
    const int64_t base = (int64_t)s * L * D + d;
    float h = 0.f;
    if (h0 != nullptr)
        h = bh0 ? rg_value<true>(rg_raw<true>(h0, s * h0_bs + d))
                : rg_value<false>(rg_raw<false>(h0, s * h0_bs + d));
    int t0 = 0;
    for (; t0 + RG_CHUNK <= L; t0 += RG_CHUNK)
        h = rg_chunk<BA, BB, false>(a, b, y, base, t0, L, D, h);
    if (t0 < L)
        h = rg_chunk<BA, BB, true>(a, b, y, base, t0, L, D, h);
    rg_store<BA>(hout, (int64_t)s * D + d, h);
}
