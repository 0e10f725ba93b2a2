// A host build of the two traceback walks (aligner_tpu_torch/csrc/walk_core.cuh:
// the replay walk W and the batched walk K4, and K4 as the counting walk)
// for the CPU tests, on the warp emulation of tests/warp_host.h: every lane
// a std::thread, the warp intrinsics emulated, a lane's cp.async copies
// landing only at its wait.  So the kernels' own bodies (the ring of staged
// word rows, the refills, the register window, the runs of TOP codes, the
// packed stream and the count) run as written, and their results are held
// against the plain PyTorch versions.
//
//     g++ -std=c++20 -O1 -pthread -shared -fPIC -I aligner_tpu_torch/csrc \
//         -o walk_host.so tests/walk_host.cpp
#include "warp_host.h"

#include "walk_core.cuh"

#include <cstdint>

// The arguments of wavefront_replay_walk_launch, without the stream.
extern "C" int replay_walk_host(const int* words, long long C_pad, int row_base,
                                int col_base, int rows, int* state, int* steps, int budget,
                                int span, int* stats) {
    if (span < 4) return -1;
    const bool vec = C_pad % 4 == 0 && span % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(words) % 16 == 0;
    auto kernel = vec ? replay_walk_kernel<4> : replay_walk_kernel<1>;
    run_grid(1, 1, size_t(walk::ring_ints(walk::REPLAY_DEPTH, span)), [&] {
        kernel(words, C_pad, row_base, col_base, rows, state, steps, budget, span, stats);
    });
    return 0;
}

// The arguments of device_walk_launch, without the stream; the blocks run
// two at a time.  -3: a block wrote past its shared memory.
extern "C" int device_walk_host(const int* words, int word_rows, int C, const int* sy,
                                const int* sx, int B, int S, int is_global, int* steps,
                                int* n, int* ey, int* ex, int warps, int blocks, int span,
                                int* stats) {
    if (warps < 1 || warps > 8 || span < 4 || (long long)blocks * warps < B) return -1;
    const bool vec = C % 4 == 0 && span % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(words) % 16 == 0;
    auto kernel = is_global
        ? (vec ? device_walk_kernel<true, 4, false> : device_walk_kernel<true, 1, false>)
        : (vec ? device_walk_kernel<false, 4, false> : device_walk_kernel<false, 1, false>);
    const bool ok = run_grid(warps, blocks, size_t(warps) * walk::walk_warp_ints(span, 0), [&] {
        kernel(words, word_rows, C, sy, sx, B, S, span, steps, n, ey, ex, stats,
               walk::CountArgs{});
    }, 2);
    return ok ? 0 : -3;
}

// The arguments of device_walk_count_launch, without the stream: the
// counting walk, its blocks run two at a time.  -3: a block wrote past its
// shared memory.
extern "C" int device_walk_count_host(const int* words, int word_rows, int C, const int* sy,
                                      const int* sx, int B, int S, int* steps, int* n,
                                      int* ey, int* ex, const int* q, int Cq, const int* t,
                                      int Rt, const unsigned char* alive, int V, int* counts,
                                      int warps, int blocks, int span, int* stats) {
    if (warps < 1 || warps > 8 || span < 4 || (long long)blocks * warps < B || Cq < 1 ||
        Rt < 1 || V < 1)
        return -1;
    const bool vec = C % 4 == 0 && span % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(words) % 16 == 0;
    auto kernel = vec ? device_walk_kernel<false, 4, true> : device_walk_kernel<false, 1, true>;
    const walk::CountArgs count{q, Cq, t, Rt, alive, V, counts};
    const bool ok = run_grid(warps, blocks, size_t(warps) * walk::walk_warp_ints(span, V), [&] {
        kernel(words, word_rows, C, sy, sx, B, S, span, steps, n, ey, ex, stats, count);
    }, 2);
    return ok ? 0 : -3;
}
