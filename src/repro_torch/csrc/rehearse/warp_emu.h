// Host stand-ins for the CUDA built-ins that the port's kernel headers use,
// so that a header compiles with g++ and its GPU threads run as host
// threads: a warp is 32 std::threads, every warp primitive is one
// std::barrier phase over them (values exchanged through a double buffer),
// and __syncthreads is a barrier over the block's threads.  Used by the
// rehearsal programs beside this file (repro_torch/rehearse.py builds and
// runs them); nothing here is compiled for the card.
#pragma once

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline

struct alignas(8) float2 {
    float x, y;
};
struct alignas(16) uint4 {
    unsigned x, y, z, w;
};

// One group of threads that synchronise together: a warp or a block.
struct EmuGroup {
    std::barrier<> bar;
    uint32_t buf[2][32];
    explicit EmuGroup(int n) : bar(n) {}
};

struct EmuThread {
    EmuGroup *warp = nullptr, *block = nullptr;
    int lane = 0;
    unsigned phase = 0;   // which half of warp->buf the next exchange uses
};
inline thread_local EmuThread emu;

inline void emu_full(unsigned mask) {
    if (mask != 0xffffffffu) {
        std::fprintf(stderr, "warp_emu: only full-warp masks are emulated\n");
        std::abort();
    }
}

// Every lane publishes v; after one barrier phase all 32 values are in the
// returned row (valid until the exchange after next).
inline const uint32_t *emu_exchange(uint32_t v) {
    uint32_t *row = emu.warp->buf[emu.phase++ & 1];
    row[emu.lane] = v;
    emu.warp->bar.arrive_and_wait();
    return row;
}

template <class T>
inline uint32_t emu_bits(T v) {
    static_assert(sizeof(T) == 4, "32-bit values only");
    uint32_t u;
    std::memcpy(&u, &v, 4);
    return u;
}
template <class T>
inline T emu_value(uint32_t u) {
    T v;
    std::memcpy(&v, &u, 4);
    return v;
}

template <class T>
inline T __shfl_sync(unsigned mask, T v, int src) {
    emu_full(mask);
    return emu_value<T>(emu_exchange(emu_bits(v))[src & 31]);
}
// Within segments of `width` lanes: the value of the lane `delta` below, or
// the lane's own where there is none.
template <class T>
inline T __shfl_up_sync(unsigned mask, T v, unsigned delta, int width = 32) {
    emu_full(mask);
    const uint32_t *row = emu_exchange(emu_bits(v));
    const bool has = emu.lane % width >= (int)delta;
    return emu_value<T>(row[has ? emu.lane - (int)delta : emu.lane]);
}
template <class T>
inline T __shfl_xor_sync(unsigned mask, T v, int lane_mask) {
    emu_full(mask);
    const uint32_t *row = emu_exchange(emu_bits(v));
    return emu_value<T>(row[(emu.lane ^ lane_mask) & 31]);
}
inline int __reduce_min_sync(unsigned mask, int v) {
    emu_full(mask);
    const uint32_t *row = emu_exchange(emu_bits(v));
    int m = emu_value<int>(row[0]);
    for (int i = 1; i < 32; ++i) m = std::min(m, emu_value<int>(row[i]));
    return m;
}
inline unsigned __reduce_min_sync(unsigned mask, unsigned v) {
    emu_full(mask);
    const uint32_t *row = emu_exchange(v);
    unsigned m = row[0];
    for (int i = 1; i < 32; ++i) m = std::min(m, row[i]);
    return m;
}
inline unsigned __reduce_add_sync(unsigned mask, unsigned v) {
    emu_full(mask);
    const uint32_t *row = emu_exchange(v);
    unsigned s = 0;
    for (int i = 0; i < 32; ++i) s += row[i];
    return s;
}
inline int __any_sync(unsigned mask, int pred) {
    emu_full(mask);
    const uint32_t *row = emu_exchange(pred != 0);
    for (int i = 0; i < 32; ++i)
        if (row[i]) return 1;
    return 0;
}
inline unsigned __match_any_sync(unsigned mask, int v) {
    emu_full(mask);
    const uint32_t *row = emu_exchange(emu_bits(v));
    unsigned peers = 0;
    for (int i = 0; i < 32; ++i)
        if (row[i] == row[emu.lane]) peers |= 1u << i;
    return peers;
}
inline unsigned __ballot_sync(unsigned mask, int pred) {
    emu_full(mask);
    const uint32_t *row = emu_exchange(pred != 0);
    unsigned votes = 0;
    for (int i = 0; i < 32; ++i)
        if (row[i]) votes |= 1u << i;
    return votes;
}
inline void __syncwarp(unsigned mask = 0xffffffffu) {
    emu_full(mask);
    emu.warp->bar.arrive_and_wait();
}
inline void __syncthreads() { emu.block->bar.arrive_and_wait(); }

// (one writer per address in the kernels that use them, so plain
// read-modify-writes)
inline unsigned atomicOr(unsigned *p, unsigned v) {
    const unsigned old = *p;
    *p = old | v;
    return old;
}
inline int atomicAdd(int *p, int v) {
    const int old = *p;
    *p = old + v;
    return old;
}

// An mbarrier in its 64-bit word of shared memory: the pending arrivals in
// bits 0-31, the arrivals a phase expects in bits 32-62, the phase's
// parity in bit 63.  An arrival is a sequentially consistent read-modify-
// write and a wait spins on sequentially consistent loads, so the stores
// before an arrival are seen after the wait that it ends.
inline void emu_bar_init(uint64_t *bar, unsigned n) {
    std::atomic_ref<uint64_t>(*bar).store((uint64_t)n << 32 | n);
}
inline void emu_bar_arrive(uint64_t *bar) {
    std::atomic_ref<uint64_t> word(*bar);
    uint64_t old = word.load(), next;
    do {
        const uint64_t expect = old >> 32 & 0x7fffffffu;
        uint64_t pending = (old & 0xffffffffu) - 1, parity = old >> 63;
        if (pending == 0) {
            pending = expect;
            parity ^= 1;
        }
        next = parity << 63 | expect << 32 | pending;
    } while (!word.compare_exchange_weak(old, next));
}
// Until the phase of parity `parity` has completed.
inline void emu_bar_wait(uint64_t *bar, unsigned parity) {
    std::atomic_ref<uint64_t> word(*bar);
    while ((word.load() >> 63) == parity)
        std::this_thread::yield();
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline float __uint_as_float(unsigned u) { return emu_value<float>(u); }
// -std=c++20 (ISO) keeps g++ from contracting a * b + c into an fma, so
// these round the product and the sum apart, as the card does
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline unsigned __float_as_uint(float f) { return emu_bits(f); }
inline float __fdiv_rn(float a, float b) { return a / b; }

// bf16 as its 16 bits; float to bf16 rounds to nearest even, as the card's
// cvt.rn.bf16.f32 and PyTorch's cast do (a NaN becomes the quiet 0x7fc0)
struct __nv_bfloat16 {
    uint16_t x;
};
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
    const uint32_t u = emu_bits(f);
    if ((u & 0x7fffffffu) > 0x7f800000u)
        return {(uint16_t)0x7fc0};
    return {(uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }

// Run fn(tid) on n_threads host threads: one block of warps of 32 (n_threads
// a multiple of 32).
inline void emu_block(int n_threads, const std::function<void(int)> &fn) {
    EmuGroup block(n_threads);
    std::vector<std::unique_ptr<EmuGroup>> warps;
    for (int w = 0; w < n_threads / 32; ++w)
        warps.push_back(std::make_unique<EmuGroup>(32));
    std::vector<std::thread> threads;
    for (int tid = 0; tid < n_threads; ++tid)
        threads.emplace_back([&, tid] {
            emu.warp = warps[tid / 32].get();
            emu.block = &block;
            emu.lane = tid % 32;
            emu.phase = 0;
            fn(tid);
        });
    for (auto &th : threads) th.join();
}

// Whole binary files of 32-bit words.
inline std::vector<uint32_t> emu_read(const char *path) {
    std::FILE *f = std::fopen(path, "rb");
    if (!f) {
        std::perror(path);
        std::exit(2);
    }
    std::vector<uint32_t> words;
    uint32_t buf[4096];
    size_t n;
    while ((n = std::fread(buf, 4, 4096, f)) > 0)
        words.insert(words.end(), buf, buf + n);
    std::fclose(f);
    return words;
}
inline void emu_write(const char *path, const std::vector<uint32_t> &words) {
    std::FILE *f = std::fopen(path, "wb");
    if (!f || std::fwrite(words.data(), 4, words.size(), f) != words.size()) {
        std::perror(path);
        std::exit(2);
    }
    std::fclose(f);
}
