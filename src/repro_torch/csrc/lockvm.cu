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
// chain, events times the latency of one event.  A fig3 sweep puts only 2-3
// warps on an SM, so nothing hides that latency: every dependent
// instruction, shared load, warp reduction and taken branch of an event
// costs its full latency.  The first design (one warp per cell, every
// per-thread row in shared memory behind a generic pointer, lane 0 applying
// a switch's twenty effect flags) spent about 1.0 us, some 2,000 cycles, per
// event.  This design (lockvm_step.cuh) keeps each acting thread's rows and
// its next instruction, already decoded, in the registers of the lane that
// owns it; an event is one warp reduction on a packed (time, index) key,
// the decode of the last actor's next instruction and one round of shared
// loads while it is in flight, the opcode's handler on the winning lane
// (which makes its own effects), two shuffles and a register wake on every
// lane, and one __syncwarp.  The state all threads share (memory, sharer
// bitsets, per-thread program registers, the lock table and the program)
// stays in the block's shared memory, addressed as such (the shared or
// scratch placement is a compile-time choice); a cell too large for it (a
// very large waiting array) runs the same code with its state, rows
// included, in a global scratch buffer the caller allocates.  Every cell of
// a fig3-sized sweep is resident at once (a 64-thread cell needs 44.7 KB),
// so there is no scheduling across cells.
//
// Built by repro_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain C shared library, loaded with ctypes; the constants header
// it includes is generated from repro_torch/sim/isa.py, costs.py and
// engine.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lockvm_step.cuh"

// SCRATCH: the state is in global scratch, else in dynamic shared memory
// (a compile-time choice, so that every state access of a shared-memory
// cell compiles to a shared-memory instruction, not a generic one).  Each
// cell takes the rows' variant its acting threads need: 1, 2 or 4 threads
// a lane in registers, else (and always in scratch) rows in memory.
template <bool SCRATCH>
__global__ void __launch_bounds__(LVM_WARP) lockvm_kernel(LvmArgs g) {
    extern __shared__ __align__(16) int32_t lvm_smem[];
    const int cell = blockIdx.x, lane = threadIdx.x;
    int32_t *S = SCRATCH ? g.scratch + (int64_t)cell * g.state_words
                         : lvm_smem;
    const int Tn = lvm_acting_threads(g, cell);
    static_assert(LVM_MAX_TPL == 4, "one instantiation per slot count");
    if constexpr (SCRATCH) {
        lvm_run_cell<0>(g, cell, lane, S, Tn);
    } else {
        if (Tn <= LVM_WARP) lvm_run_cell<1>(g, cell, lane, S, Tn);
        else if (Tn <= 2 * LVM_WARP) lvm_run_cell<2>(g, cell, lane, S, Tn);
        else if (Tn <= 4 * LVM_WARP) lvm_run_cell<4>(g, cell, lane, S, Tn);
        else lvm_run_cell<0>(g, cell, lane, S, Tn);
    }
}

template <bool SCRATCH>
static int lockvm_launch(const LvmArgs &g, size_t smem, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            lockvm_kernel<SCRATCH>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    lockvm_kernel<SCRATCH><<<g.n_cells, LVM_WARP, smem, stream>>>(g);
    return (int)cudaGetLastError();
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

    const cudaStream_t st = (cudaStream_t)stream;
    // a cell too large for shared memory keeps even its rows in scratch
    if (scratch) return lockvm_launch<true>(g, 0, st);
    return lockvm_launch<false>(
        g, (size_t)g.state_words * sizeof(int32_t), st);
}
