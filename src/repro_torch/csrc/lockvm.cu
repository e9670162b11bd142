// lockVM sweep kernel for Hopper (sm_90a): the whole event loop of every
// sweep cell, one thread block (one warp) per cell.
//
// Replaces the Pallas kernel make_run_pallas (src/repro/sim/engine_pallas.py,
// pl.pallas_call at line 154) and computes what it computes: for each cell,
// the lockVM's initial state, then events until the single-cell loop's
// stop condition, then the final stats (acquisitions, waited acquisitions,
// handover sum/count, events, sleeping threads, final memory, the log2
// acquire-latency histogram).  It does not copy the Pallas kernel's
// structure: the burst-and-overshoot loop there exists only so that XLA
// does not test termination after every step; here the loop is simply
// `while (live) step();`.
//
// What bounds it on this card: neither bytes nor arithmetic.  A cell reads
// its inputs and writes its stats once (tens of kilobytes); what remains is
// a serial chain of events — each event's selection depends on the
// previous event's effects — so a sweep takes as long as its longest cell's
// chain of dependent steps.  The design keeps that chain short: the whole
// hot state (memory, sharer bitsets, per-thread timelines, registers and
// the program) sits in the block's shared memory, and one warp works each
// event, with the lane-parallel pieces (the event argmin over 2T times, the
// sharer-row popcount, the wake scan, the fault phase) spread over its 32
// lanes and the scalar writes made by lane 0.  Every cell of a fig3-sized
// sweep is resident at once (a 64-thread cell needs 42 KB), so there is no
// scheduling across cells.  A cell too large for shared memory (a very
// large waiting array) runs the same code with its state in a global
// scratch buffer the caller allocates.
//
// Built by repro_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain C shared library, loaded with ctypes; the constants header
// it includes is generated from repro_torch/sim/isa.py, costs.py and
// engine.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lockvm_step.cuh"

__global__ void __launch_bounds__(LVM_WARP) lockvm_kernel(LvmArgs g) {
    extern __shared__ __align__(16) int32_t lvm_smem[];
    const int cell = blockIdx.x;
    int32_t *S = g.scratch ? g.scratch + (int64_t)cell * g.state_words
                           : lvm_smem;
    lvm_run_cell(g, cell, threadIdx.x, S);
}

// Words of state one cell keeps (shared memory, or global scratch).
extern "C" int64_t lockvm_state_words(int n_threads, int mem_words,
                                      int n_locks, int prog_len) {
    return lvm_layout(n_threads, mem_words, n_locks, prog_len).total;
}

// Launch the kernel over n_cells cells on `stream`.  Returns the CUDA error
// of the launch (0 = launched); it does not synchronise.  `scratch` is null
// to keep each cell's state in dynamic shared memory, or a device buffer of
// n_cells * lockvm_state_words(...) int32 words.
extern "C" int lockvm_run(
    const void *program, const void *init_pc, const void *init_regs,
    const void *init_mem, const void *n_active, const void *seed,
    const void *horizon, const void *max_events, const void *costs,
    const void *wa_base, const void *wa_mask, const void *wa_size,
    const void *f_kind, const void *f_evt, const void *f_tid,
    const void *f_arg, void *out_acq, void *out_waited, void *out_hand_sum,
    void *out_hand_cnt, void *out_events, void *out_sleeping, void *out_mem,
    void *out_lat, void *scratch, int n_cells, int n_threads, int mem_words,
    int n_locks, int prog_len, int n_faults, void *stream) {
    LvmArgs g;
    g.program = (const int32_t *)program;
    g.init_pc = (const int32_t *)init_pc;
    g.init_regs = (const int32_t *)init_regs;
    g.init_mem = (const int32_t *)init_mem;
    g.n_active = (const int32_t *)n_active;
    g.seed = (const int32_t *)seed;
    g.horizon = (const int32_t *)horizon;
    g.max_events = (const int32_t *)max_events;
    g.costs = (const int32_t *)costs;
    g.wa_base = (const int32_t *)wa_base;
    g.wa_mask = (const int32_t *)wa_mask;
    g.wa_size = (const int32_t *)wa_size;
    g.f_kind = (const int32_t *)f_kind;
    g.f_evt = (const int32_t *)f_evt;
    g.f_tid = (const int32_t *)f_tid;
    g.f_arg = (const int32_t *)f_arg;
    g.out_acq = (int32_t *)out_acq;
    g.out_waited = (int32_t *)out_waited;
    g.out_hand_sum = (int32_t *)out_hand_sum;
    g.out_hand_cnt = (int32_t *)out_hand_cnt;
    g.out_events = (int32_t *)out_events;
    g.out_sleeping = (int32_t *)out_sleeping;
    g.out_mem = (int32_t *)out_mem;
    g.out_lat = (int32_t *)out_lat;
    g.n_cells = n_cells;
    g.n_threads = n_threads;
    g.mem_words = mem_words;
    g.n_locks = n_locks;
    g.prog_len = prog_len;
    g.n_faults = n_faults;
    g.scratch = (int32_t *)scratch;
    g.state_words = lvm_layout(n_threads, mem_words, n_locks, prog_len).total;
    if (n_cells <= 0) return 0;

    size_t smem = scratch ? 0 : (size_t)g.state_words * sizeof(int32_t);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            lockvm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    lockvm_kernel<<<n_cells, LVM_WARP, smem, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}
