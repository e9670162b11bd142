// Host rehearsal of the RG-LRU scan kernel's device code
// (rglru_scan_kernel.cuh): the same rg_block that rglru_scan.cu launches,
// each block's RG_THREADS threads run as host threads (warp_emu.h), the
// blocks one after another.  The ring's primitives are plain copies, which
// land at once, and emulated mbarriers; a, b and y sit in 16-byte aligned
// buffers, so rg_vec_ok chooses the 16-byte path from D as on the card.
//
//   rglru_scan_host IN OUT
//
// IN holds int32 words: batch, L, D, h0_bs, the dtype mask (RG_BF16_*
// bits), has_h0; then the raw bytes of a, b and (if has_h0) h0 in their
// dtypes, each padded to whole words.  OUT receives y, then h_final, in a's
// dtype, each padded the same way.  Built by repro_torch/rehearse.py with
// the generated constants header.
#include "warp_emu.h"

inline void rg_bar_init(uint64_t *bar, unsigned n) { emu_bar_init(bar, n); }
inline void rg_bar_arrive(uint64_t *bar) { emu_bar_arrive(bar); }
inline void rg_bar_wait(uint64_t *bar, unsigned par) {
    emu_bar_wait(bar, par);
}
inline void rg_copy16(void *dst, const void *src) { std::memcpy(dst, src, 16); }
inline void rg_copies_arrive(uint64_t *bar) { emu_bar_arrive(bar); }
// float32 -> bf16 rounded to nearest even, NaN kept quiet (PyTorch's rule)
inline uint16_t rg_bf16(float v) {
    uint32_t u = emu_bits(v);
    if ((u & 0x7fffffffu) > 0x7f800000u)
        return 0x7fc0;
    u += 0x7fffu + ((u >> 16) & 1u);
    return (uint16_t)(u >> 16);
}

#include "rglru_scan_kernel.cuh"

// n bytes, zeroed, on 16 bytes
static std::vector<uint4> aligned(int64_t n) {
    return std::vector<uint4>((n + 15) / 16, uint4{0, 0, 0, 0});
}

template <bool BA, bool BB, bool VEC>
static void run(const void *a, const void *b, const void *h0, void *y,
                void *hout, int batch, int L, int D, int64_t h0_bs,
                bool bh0) {
    for (int s = 0; s < batch; ++s)
        for (int d0 = 0; d0 < D; d0 += RG_CHANNELS) {
            std::vector<uint4> smem = aligned(
                rg_smem_bytes(BA ? 2 : 4, BB ? 2 : 4));
            emu_block(RG_THREADS, [&](int tid) {
                rg_block<BA, BB, VEC>(a, b, h0, y, hout, L, D, h0_bs, bh0,
                                      s, d0, tid, (char *)smem.data());
            });
        }
}

template <bool BA, bool BB>
static void run_any(const void *a, const void *b, const void *h0, void *y,
                    void *hout, int batch, int L, int D, int64_t h0_bs,
                    bool bh0) {
    if (rg_vec_ok(a, b, y, D, BA ? 2 : 4, BB ? 2 : 4))
        run<BA, BB, true>(a, b, h0, y, hout, batch, L, D, h0_bs, bh0);
    else
        run<BA, BB, false>(a, b, h0, y, hout, batch, L, D, h0_bs, bh0);
}

int main(int argc, char **argv) {
    if (argc != 3) {
        std::fprintf(stderr, "usage: %s IN OUT\n", argv[0]);
        return 2;
    }
    std::vector<uint32_t> words = emu_read(argv[1]);
    const int32_t *w = (const int32_t *)words.data();
    const int batch = w[0], L = w[1], D = w[2];
    const int64_t h0_bs = w[3];
    const unsigned mask = (unsigned)w[4];
    const bool has_h0 = w[5] != 0;
    const int64_t counts[3] = {(int64_t)batch * L * D, (int64_t)batch * L * D,
                               has_h0 ? (h0_bs ? (int64_t)batch * D : D) : 0};
    const unsigned bits[3] = {RG_BF16_A, RG_BF16_B, RG_BF16_H0};
    std::vector<uint4> in[3];
    size_t at = 6;
    for (int i = 0; i < 3; ++i) {
        const int64_t bytes = counts[i] * ((mask & bits[i]) ? 2 : 4);
        in[i] = aligned(bytes);
        if (at + (bytes + 3) / 4 <= words.size())
            std::memcpy(in[i].data(), words.data() + at, bytes);
        at += (bytes + 3) / 4;
    }
    if (at != words.size()) {
        std::fprintf(stderr, "rglru_scan_host: %zu words read, %zu given\n",
                     at, words.size());
        return 2;
    }
    const bool ba = mask & RG_BF16_A, bb = mask & RG_BF16_B;
    const bool bh0 = mask & RG_BF16_H0;
    const int esize = ba ? 2 : 4;
    const int64_t ny = counts[0], nh = (int64_t)batch * D;
    std::vector<uint4> y = aligned(ny * esize), hout = aligned(nh * esize);
    const void *a = in[0].data(), *b = in[1].data();
    const void *h0 = has_h0 ? in[2].data() : nullptr;
    if (ba && bb)
        run_any<true, true>(a, b, h0, y.data(), hout.data(), batch, L, D,
                            h0_bs, bh0);
    else if (ba)
        run_any<true, false>(a, b, h0, y.data(), hout.data(), batch, L, D,
                             h0_bs, bh0);
    else if (bb)
        run_any<false, true>(a, b, h0, y.data(), hout.data(), batch, L, D,
                             h0_bs, bh0);
    else
        run_any<false, false>(a, b, h0, y.data(), hout.data(), batch, L, D,
                              h0_bs, bh0);
    const int64_t wy = (ny * esize + 3) / 4, wh = (nh * esize + 3) / 4;
    std::vector<uint32_t> out(wy + wh, 0);
    std::memcpy(out.data(), y.data(), ny * esize);
    std::memcpy(out.data() + wy, hout.data(), nh * esize);
    emu_write(argv[2], out);
    return 0;
}
