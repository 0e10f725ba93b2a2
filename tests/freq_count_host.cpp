// A host build of the population's frequency count
// (aligner_tpu_torch/csrc/freq_count.cu) for the CPU tests, on the warp
// emulation of tests/warp_host.h: every lane a std::thread, the warp
// shuffles and the shared-memory atomics emulated.  So the kernel's own body
// (the rounds of 32 words, the warp scan of the cursor, the replay of each
// lane's codes, the seed pair) runs as written, and its counts are held
// against the plain PyTorch version.
//
//     g++ -std=c++20 -O1 -pthread -shared -fPIC -I aligner_tpu_torch/csrc \
//         -o freq_count_host.so tests/freq_count_host.cpp
#include "warp_host.h"

#include "freq_count.cu"

// The arguments of freq_count_launch, without the stream; the blocks run
// two at a time.
extern "C" int freq_count_host(const int* steps, int words, const int* n, const int* sy,
                               const int* sx, const int* q, int C, const int* t, int R,
                               const unsigned char* alive, int M, int V, int* out) {
    if (V < 1 || C < 1 || R < 1) return -1;
    const int blocks = (M + fc::WARPS - 1) / fc::WARPS;
    run_grid(fc::WARPS, blocks, size_t(fc::WARPS) * V * V, [&] {
        freq_count_kernel(steps, words, n, sy, sx, q, C, t, R, alive, M, V, out);
    }, 2);
    return 0;
}
