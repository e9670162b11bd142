// Device code of the RG-LRU scan kernel: one block's RG_CHANNELS channels
// of one sequence, walked over all L steps by a chain warp (one lane a
// channel) that reads a and b from a ring of RG_STAGES stages in shared
// memory, each RG_STEPS steps deep, which a copy warp fills ahead of it and
// a store warp drains of y behind it.  Included by rglru_scan.cu.
//
// The ring's primitives come from the includer: rglru_scan.cu defines them
// with cp.async and mbarriers, the host rehearsal
// (csrc/rehearse/rglru_scan_host.cpp) as plain copies and emulated
// barriers, so that this file's logic runs on a host without a card.
//   rg_bar_init(bar, n)      a barrier whose phase completes after n
//                            arrivals;
//   rg_bar_arrive(bar)       one arrival, ordering this thread's earlier
//                            shared-memory stores before it;
//   rg_bar_wait(bar, par)    until the phase of parity par has completed;
//   rg_copy16(dst, src)      issue a 16-byte copy from device memory into
//                            shared memory;
//   rg_copies_arrive(bar)    one arrival once every copy this thread
//                            issued has landed;
//   rg_bf16(v)               the bf16 bits of v, rounded to nearest even.
// It also uses __fmul_rn, __fadd_rn, __syncthreads, __syncwarp and the bit
// casts __float_as_uint / __uint_as_float.
#pragma once

#include <stdint.h>

// From the generated constants header: the channels of a block (the
// chain warp's lanes), its threads (the chain, copy and store warps), the
// steps of a stage, the stages of the ring, and one bit per input of the
// dtype mask (RG_BF16_A, _B, _H0: set = bf16, clear = float32; the outputs
// y and h_final take a's dtype).
#if !defined(RG_CHANNELS) || !defined(RG_THREADS) || !defined(RG_STEPS) || \
    !defined(RG_STAGES) || !defined(RG_BF16_A) || !defined(RG_BF16_B) ||   \
    !defined(RG_BF16_H0)
#error "RG_* come from the generated constants header"
#endif
#if RG_CHANNELS != 32 || RG_THREADS != 96
#error "a chain warp of 32 channels, a copy warp and a store warp a block"
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

// Element i of p set to v, in bf16 (rounded to nearest even) or float32.
template <bool BF16>
__device__ __forceinline__ void rg_store(void *p, int64_t i, float v) {
    if (BF16)
        ((uint16_t *)p)[i] = rg_bf16(v);
    else
        ((float *)p)[i] = v;
}

// Bytes of one stage's a (then b) in the ring: RG_STEPS rows of the
// block's RG_CHANNELS channels, laid out as in device memory.
__host__ __device__ constexpr int rg_rows_bytes(int esize) {
    return RG_STEPS * RG_CHANNELS * esize;
}

// Dynamic shared memory of one block: three 8-byte barriers a stage, then
// the ring (16-byte aligned).
__host__ __device__ constexpr int rg_smem_bytes(int ea, int eb) {
    return 32 * RG_STAGES + RG_STAGES * (rg_rows_bytes(ea) +
                                         rg_rows_bytes(eb));
}

// Whether the copy warp may move whole 16-byte pieces: every row of a, b
// and y starts on 16 bytes (aligned bases, rows of a multiple of 16 bytes).
// Then a block's RG_CHANNELS channels (64 or 128 bytes) are whole pieces
// too, and a ragged last block holds whole pieces of its channels.
inline bool rg_vec_ok(const void *a, const void *b, const void *y, int D,
                      int ea, int eb) {
    return ((uintptr_t)a | (uintptr_t)b | (uintptr_t)y) % 16 == 0 &&
           (int64_t)D * ea % 16 == 0 && (int64_t)D * eb % 16 == 0;
}

// The chain of one stage of n steps (n = RG_STEPS unless TAIL) of channel
// c from state h: returns the new state.  sa and sb are the stage's rows
// of a and b in the ring; y_t is written over a_t, which is read first,
// for the store warp to drain.  Every load of the stage is issued, into
// registers ra and rb (fully unrolled), before the first of them is used,
// and the bits stay raw until the step that uses them: an instruction that
// reads a loaded register stalls until the load is back.  A full stage is
// straight-line code.  The product and the sum are rounded separately (no
// fused multiply-add), as the plain loop rounds them: on float32 inputs
// the two agree bit for bit.
template <bool BA, bool BB, bool TAIL>
__device__ __forceinline__ float rg_stage(char *sa, const char *sb, int n,
                                          int c, float h) {
    uint32_t ra[RG_STEPS], rb[RG_STEPS];
#pragma unroll
    for (int k = 0; k < RG_STEPS; ++k) {
        if (!TAIL || k < n) {
            ra[k] = rg_raw<BA>(sa, k * RG_CHANNELS + c);
            rb[k] = rg_raw<BB>(sb, k * RG_CHANNELS + c);
        }
    }
#pragma unroll
    for (int k = 0; k < RG_STEPS; ++k) {
        if (!TAIL || k < n) {
            h = __fadd_rn(__fmul_rn(rg_value<BA>(ra[k]), h),
                          rg_value<BB>(rb[k]));
            rg_store<BA>(sa, k * RG_CHANNELS + c, h);
        }
    }
    return h;
}

// The copy warp's move of one stage's rows between device memory (g, the
// element of row 0 at the block's first channel, rows D apart) and the
// ring (s), `rows` rows of `width` channels.  VEC: 16-byte pieces, one per
// lane in turn, by rg_copy16 into the ring (TO_RING) or by a 16-byte load
// and store out of it.  Otherwise one element per lane (its channel) and
// row, every load of the stage issued before the first store, so that a
// stage waits one memory round trip and not one a row.
template <bool VEC, bool TO_RING, int E>
__device__ __forceinline__ void rg_move(void *s, void *g, int rows,
                                        int width, int D, int lane) {
    if (VEC) {
        constexpr int per_row = RG_CHANNELS * E / 16;
        const int used = width * E / 16;   // pieces of a row in the block
        for (int q = lane; q < rows * per_row; q += 32) {
            const int r = q / per_row, p = q % per_row;
            if (p >= used)
                continue;
            char *sp = (char *)s + r * (RG_CHANNELS * E) + 16 * p;
            char *gp = (char *)g + ((int64_t)r * D * E + 16 * p);
            if (TO_RING)
                rg_copy16(sp, gp);
            else
                *(uint4 *)gp = *(const uint4 *)sp;
        }
        return;
    }
    if (lane >= width)
        return;
    char *src = TO_RING ? (char *)g : (char *)s;
    char *dst = TO_RING ? (char *)s : (char *)g;
    const int64_t src_row = (TO_RING ? (int64_t)D : RG_CHANNELS) * E;
    const int64_t dst_row = (TO_RING ? RG_CHANNELS : (int64_t)D) * E;
    uint32_t v[RG_STEPS];
#pragma unroll
    for (int r = 0; r < RG_STEPS; ++r)
        if (r < rows)
            v[r] = rg_raw<E == 2>(src + r * src_row, lane);
#pragma unroll
    for (int r = 0; r < RG_STEPS; ++r) {
        if (r < rows) {
            if (E == 2)
                ((uint16_t *)(dst + r * dst_row))[lane] = (uint16_t)v[r];
            else
                ((uint32_t *)(dst + r * dst_row))[lane] = v[r];
        }
    }
}

// The scan of channels [d0, d0 + RG_CHANNELS) of sequence s: h_t = a_t *
// h_{t-1} + b_t for t in [0, L), h from h0 (null: zeros) and kept in a
// float32 register of the chain warp (warp 0), lane c on channel d0 + c.
// Slot j of the ring takes stages j, j + RG_STAGES, ...: the copy warp
// (warp 1) fills it with that stage's rows of a and b once the store warp
// has freed it, and the store warp (warp 2) writes its y to device memory
// once the chain has run it.  Three barriers a slot: full[j] completes a
// phase when the copy warp's 32 lanes have filled it, done[j] when the
// chain's 32 lanes have run it, freed[j] when the store warp's 32 lanes
// have read its y.  y's stores leave from a warp that issues no copies, so
// the copies' arrivals never wait behind them.  Row-major layouts: a, b, y (batch, L, D); h0 (., D) with batch
// stride h0_bs (0: shared); h_final (batch, D).  BA and BB say whether a
// and b are bf16; y and h_final take a's dtype.  VEC: rg_vec_ok holds.
// `smem` holds rg_smem_bytes, 16-byte aligned.
template <bool BA, bool BB, bool VEC>
__device__ __forceinline__ void rg_block(const void *a, const void *b,
                                         const void *h0, void *y,
                                         void *hout, int L, int D,
                                         int64_t h0_bs, bool bh0, int s,
                                         int d0, int tid, char *smem) {
    constexpr int EA = BA ? 2 : 4, EB = BB ? 2 : 4;
    constexpr int SLOT = rg_rows_bytes(EA) + rg_rows_bytes(EB);
    uint64_t *full = (uint64_t *)smem, *done = full + RG_STAGES;
    uint64_t *freed = done + RG_STAGES;
    char *ring = smem + 32 * RG_STAGES;
    if (tid == 0)
        for (int j = 0; j < RG_STAGES; ++j) {
            rg_bar_init(&full[j], 32);
            rg_bar_init(&done[j], 32);
            rg_bar_init(&freed[j], 32);
        }
    __syncthreads();
    const int n_st = (L + RG_STEPS - 1) / RG_STEPS;
    const int warp = tid >> 5, lane = tid & 31;
    const int width = D - d0 < RG_CHANNELS ? D - d0 : RG_CHANNELS;
    const int64_t base = (int64_t)s * L * D + d0;
    // stage k sits in slot j = k % RG_STAGES in round k / RG_STAGES, whose
    // parity is par; its rows: min(RG_STEPS, L - k RG_STEPS)
    if (warp == 0) {                             // the chain
        const int d = d0 + lane;
        float h = 0.f;
        if (h0 != nullptr && lane < width)
            h = bh0 ? rg_value<true>(rg_raw<true>(h0, s * h0_bs + d))
                    : rg_value<false>(rg_raw<false>(h0, s * h0_bs + d));
        for (int k = 0, j = 0, par = 0; k < n_st; ++k) {
            char *sa = ring + j * SLOT;
            const int n = L - k * RG_STEPS;
            rg_bar_wait(&full[j], par);
            if (n >= RG_STEPS)
                h = rg_stage<BA, BB, false>(sa, sa + rg_rows_bytes(EA),
                                            RG_STEPS, lane, h);
            else
                h = rg_stage<BA, BB, true>(sa, sa + rg_rows_bytes(EA), n,
                                           lane, h);
            rg_bar_arrive(&done[j]);
            if (++j == RG_STAGES) {
                j = 0;
                par ^= 1;
            }
        }
        if (lane < width)
            rg_store<BA>(hout, (int64_t)s * D + d, h);
    } else if (warp == 1) {                      // the copy warp
        for (int k = 0, j = 0, par = 0; k < n_st; ++k) {
            char *sa = ring + j * SLOT;
            const int n = L - k * RG_STEPS;
            const int rows = n < RG_STEPS ? n : RG_STEPS;
            const int64_t row0 = base + (int64_t)k * RG_STEPS * D;
            if (k >= RG_STAGES)                  // y of stage k - RG_STAGES
                rg_bar_wait(&freed[j], par ^ 1); // is out of the slot
            rg_move<VEC, true, EA>(sa, (char *)a + row0 * EA, rows, width,
                                   D, lane);
            rg_move<VEC, true, EB>(sa + rg_rows_bytes(EA),
                                   (char *)b + row0 * EB, rows, width, D,
                                   lane);
            if (VEC)
                rg_copies_arrive(&full[j]);
            else
                rg_bar_arrive(&full[j]);
            if (++j == RG_STAGES) {
                j = 0;
                par ^= 1;
            }
        }
    } else {                                     // the store warp
        for (int k = 0, j = 0, par = 0; k < n_st; ++k) {
            char *sa = ring + j * SLOT;
            const int n = L - k * RG_STEPS;
            const int rows = n < RG_STEPS ? n : RG_STEPS;
            const int64_t row0 = base + (int64_t)k * RG_STEPS * D;
            rg_bar_wait(&done[j], par);
            rg_move<VEC, false, EA>(sa, (char *)y + row0 * EA, rows, width,
                                    D, lane);
            rg_bar_arrive(&freed[j]);
            if (++j == RG_STAGES) {
                j = 0;
                par ^= 1;
            }
        }
    }
}
