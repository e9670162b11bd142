// Host rehearsal of the causal conv kernel's device code
// (causal_conv_kernel.cuh): the same cc_thread that causal_conv.cu
// launches, for every (sequence, run, channel group) in turn.  No thread
// of it waits for another, so they run one after another.
//
//   causal_conv_host IN OUT
//
// IN holds int32 words: batch, S, d, kw, sb, sr, run, the flags word
// (CC_FLAG_* bits), nx; then the raw bytes of x (nx elements from its
// first, which (b, t, c) reads at b * sb + t * sr + c), w (d, kw) and b
// (d,) in the dtype the flags give, each padded to whole words.  Each is
// copied to a 16-byte-aligned buffer, as the card's allocations are.  OUT
// receives y (batch, S, d), then the tail (batch, kw-1, d), each padded the
// same way.  Built by repro_torch/rehearse.py with the generated constants
// header.
#include "warp_emu.h"

#include "causal_conv_kernel.cuh"

// n elements of esize bytes from `words` at `at` (advanced past them), in a
// 16-byte-aligned buffer.
static std::vector<uint4> take(const std::vector<uint32_t> &words,
                               size_t &at, int64_t n, int esize) {
    const int64_t bytes = n * esize;
    std::vector<uint4> buf((bytes + 15) / 16 + 1);
    std::memcpy(buf.data(), words.data() + at, bytes);
    at += (bytes + 3) / 4;
    return buf;
}

template <int KW>
static void run_all(const void *x, const void *w, const void *b, void *y,
                    void *tail, int batch, int S, int d, int64_t sb,
                    int64_t sr, int run, unsigned flags) {
    const int groups = (d + CC_CHANNELS - 1) / CC_CHANNELS;
    for (int s = 0; s < batch; ++s)
        for (int r = 0; r * run < S; ++r)
            for (int g = 0; g < groups; ++g) {
                if (flags & CC_FLAG_BF16)
                    cc_thread<KW, true>(x, w, b, y, tail, S, d, sb, sr, run,
                                        flags, s, g, r);
                else
                    cc_thread<KW, false>(x, w, b, y, tail, S, d, sb, sr, run,
                                         flags, s, g, r);
            }
}

int main(int argc, char **argv) {
    if (argc != 3) {
        std::fprintf(stderr, "usage: %s IN OUT\n", argv[0]);
        return 2;
    }
    std::vector<uint32_t> words = emu_read(argv[1]);
    const int32_t *h = (const int32_t *)words.data();
    const int batch = h[0], S = h[1], d = h[2], kw = h[3];
    const int64_t sb = h[4], sr = h[5];
    const int run = h[6];
    const unsigned flags = (unsigned)h[7];
    const int64_t nx = h[8];
    const int esize = (flags & CC_FLAG_BF16) ? 2 : 4;
    size_t at = 9;
    const std::vector<uint4> x = take(words, at, nx, esize);
    const std::vector<uint4> w = take(words, at, (int64_t)d * kw, esize);
    const std::vector<uint4> b = take(words, at, d, esize);
    if (at != words.size()) {
        std::fprintf(stderr, "causal_conv_host: %zu words read, %zu given\n",
                     at, words.size());
        return 2;
    }
    const int64_t ny = (int64_t)batch * S * d;
    const int64_t nt = (int64_t)batch * (kw - 1) * d;
    std::vector<uint4> y((ny * esize + 15) / 16 + 1);
    std::vector<uint4> tail((nt * esize + 15) / 16 + 1);
    switch (kw) {
    case 2:
        run_all<2>(x.data(), w.data(), b.data(), y.data(), tail.data(), batch,
                   S, d, sb, sr, run, flags);
        break;
    case 3:
        run_all<3>(x.data(), w.data(), b.data(), y.data(), tail.data(), batch,
                   S, d, sb, sr, run, flags);
        break;
    case 4:
        run_all<4>(x.data(), w.data(), b.data(), y.data(), tail.data(), batch,
                   S, d, sb, sr, run, flags);
        break;
    default:
        std::fprintf(stderr, "causal_conv_host: no kernel for width %d\n",
                     kw);
        return 2;
    }
    const int64_t wy = (ny * esize + 3) / 4, wt = (nt * esize + 3) / 4;
    std::vector<uint32_t> out(wy + wt, 0);
    std::memcpy(out.data(), y.data(), ny * esize);
    std::memcpy(out.data() + wy, tail.data(), nt * esize);
    emu_write(argv[2], out);
    return 0;
}
