// Host rehearsal of the selective-scan kernel's device code
// (mamba_scan_kernel.cuh): the same ms_block that mamba_scan.cu launches,
// each block's MS_THREADS threads run as host threads (warp_emu.h), the
// blocks one after another.
//
//   mamba_scan_host IN OUT
//
// IN holds int32 words: batch, L, D, N, a_bs, dsk_bs, h0_bs, the dtype mask
// (MS_BF16_* bits), has_h0; then the raw bytes of x, dt, A, B, C,
// D_skip and (if has_h0) h0 in their dtypes, each padded to whole words.
// OUT receives y, then h_final, in x's dtype, each padded the same way.
// Built by repro_torch/rehearse.py with the generated constants header.
#include "warp_emu.h"

#include "mamba_scan_kernel.cuh"

template <int N>
static void run(const void *const *in, void *y, void *hout, int batch, int L,
                int D, int64_t a_bs, int64_t dsk_bs, int64_t h0_bs,
                unsigned mask) {
    constexpr int ch = MS_THREADS / MS_LANES;
    for (int b = 0; b < batch; ++b)
        for (int d0 = 0; d0 < D; d0 += ch) {
            std::vector<float2> sxd(2 * MS_CHUNK * ch), sbc(2 * MS_CHUNK * N);
            emu_block(MS_THREADS, [&](int tid) {
                ms_block<N>(in[0], in[1], in[2], in[3], in[4], in[5], in[6],
                            y, hout, L, D, a_bs, dsk_bs, h0_bs, mask, b, d0,
                            tid, sxd.data(), sbc.data());
            });
        }
}

int main(int argc, char **argv) {
    if (argc != 3) {
        std::fprintf(stderr, "usage: %s IN OUT\n", argv[0]);
        return 2;
    }
    std::vector<uint32_t> words = emu_read(argv[1]);
    const int32_t *w = (const int32_t *)words.data();
    const int batch = w[0], L = w[1], D = w[2], N = w[3];
    const int64_t a_bs = w[4], dsk_bs = w[5], h0_bs = w[6];
    const unsigned mask = (unsigned)w[7];
    const bool has_h0 = w[8] != 0;
    const int64_t na = a_bs ? (int64_t)batch * D * N : (int64_t)D * N;
    const int64_t nh = h0_bs ? (int64_t)batch * D * N : (int64_t)D * N;
    const int64_t counts[7] = {
        (int64_t)batch * L * D, (int64_t)batch * L * D, na,
        (int64_t)batch * L * N, (int64_t)batch * L * N,
        dsk_bs ? (int64_t)batch * D : D, has_h0 ? nh : 0};
    const unsigned bits[7] = {MS_BF16_X, MS_BF16_DT, MS_BF16_A, MS_BF16_B,
                              MS_BF16_C, MS_BF16_D_SKIP, MS_BF16_H0};
    const void *in[7];
    size_t at = 9;
    for (int i = 0; i < 7; ++i) {
        const int64_t bytes = counts[i] * ((mask & bits[i]) ? 2 : 4);
        in[i] = counts[i] ? (const void *)(words.data() + at) : nullptr;
        at += (bytes + 3) / 4;
    }
    if (at != words.size()) {
        std::fprintf(stderr, "mamba_scan_host: %zu words read, %zu given\n",
                     at, words.size());
        return 2;
    }
    const int esize = (mask & MS_BF16_X) ? 2 : 4;
    const int64_t ny = (int64_t)batch * L * D, nhf = (int64_t)batch * D * N;
    const int64_t wy = (ny * esize + 3) / 4, wh = (nhf * esize + 3) / 4;
    std::vector<uint32_t> out(wy + wh, 0);
    void *y = out.data(), *hout = out.data() + wy;
    switch (N) {
    case 4: run<4>(in, y, hout, batch, L, D, a_bs, dsk_bs, h0_bs, mask); break;
    case 8: run<8>(in, y, hout, batch, L, D, a_bs, dsk_bs, h0_bs, mask); break;
    case 16:
        run<16>(in, y, hout, batch, L, D, a_bs, dsk_bs, h0_bs, mask);
        break;
    default:
        std::fprintf(stderr, "mamba_scan_host: no kernel for N %d\n", N);
        return 2;
    }
    emu_write(argv[2], out);
    return 0;
}
