// Host rehearsal of the ticket-dispatch kernel's device code
// (ticket_dispatch_kernel.cuh): the same td_group that ticket_dispatch.cu
// launches, each group's TD_THREADS threads run as host threads
// (warp_emu.h), the groups one after another.
//
//   ticket_dispatch_host IN OUT
//
// IN holds int32 words: groups, n, n_experts, capacity, then the ids
// (groups x n, row-major).  OUT receives the tickets, then the slots, in
// the same layout.  Built by repro_torch/rehearse.py with the generated
// constants header.
#include "warp_emu.h"

#include "ticket_dispatch_kernel.cuh"

int main(int argc, char **argv) {
    if (argc != 3) {
        std::fprintf(stderr, "usage: %s IN OUT\n", argv[0]);
        return 2;
    }
    std::vector<uint32_t> words = emu_read(argv[1]);
    const int32_t *w = (const int32_t *)words.data();
    const int groups = w[0], n_experts = w[2], capacity = w[3];
    const int64_t n = w[1];
    if (words.size() != 4 + (size_t)groups * n) {
        std::fprintf(stderr, "ticket_dispatch_host: %zu words, expected "
                     "%lld\n", words.size(), 4 + (long long)groups * n);
        return 2;
    }
    const int32_t *ids = w + 4;
    std::vector<uint32_t> out(2 * (size_t)groups * n, 0);
    int32_t *tickets = (int32_t *)out.data();
    int32_t *slots = tickets + (size_t)groups * n;
    for (int g = 0; g < groups; ++g) {
        std::vector<int32_t> smem((size_t)td_smem_words(n_experts), -7);
        emu_block(TD_THREADS, [&](int tid) {
            td_group(ids + g * n, tickets + g * n, slots + g * n, n,
                     n_experts, capacity, tid, smem.data());
        });
    }
    emu_write(argv[2], out);
    return 0;
}
