// A host build of the strip walk (aligner_tpu_torch/csrc/wavefront_tile.cuh)
// for the CPU tests, on the warp emulation of tests/warp_host.h: every lane
// a std::thread, the warp intrinsics emulated.  So the kernel's own body
// (its lane pipeline, the ring, the chunk loads and the waits between
// strips) runs as written, with real concurrency between warps, and its
// results are held against the plain PyTorch versions.
//
//     g++ -std=c++20 -O1 -pthread -shared -fPIC -I aligner_tpu_torch/csrc \
//         -o strip_walk_host.so tests/strip_walk_host.cpp
#include "warp_host.h"

#include "wavefront_tile.cuh"

template <int K, bool DIRS, bool BLOCK>
void run_strips(const TileArgs& a, int warps, int blocks) {
    run_grid(warps, blocks, strip_smem_bytes(a.V, a.TR, warps) / sizeof(int),
             [&a] { fill_strips_kernel<K, DIRS, BLOCK>(a); });
}

template <bool BLOCK>
int run(const TileArgs& a, int K, int warps, int blocks) {
    const bool d = a.words != nullptr;
    switch (K) {
        case 2: d ? run_strips<2, true, BLOCK>(a, warps, blocks)
                  : run_strips<2, false, BLOCK>(a, warps, blocks); return 0;
        case 4: d ? run_strips<4, true, BLOCK>(a, warps, blocks)
                  : run_strips<4, false, BLOCK>(a, warps, blocks); return 0;
        case 8: d ? run_strips<8, true, BLOCK>(a, warps, blocks)
                  : run_strips<8, false, BLOCK>(a, warps, blocks); return 0;
        default: return -1;
    }
}

// The arguments of wavefront_block_cs_launch (lbound, hrow and rights null
// for the row-scan fill, x0 then 0), `block` choosing the instance; `hand`
// (width,) and `sync` (1,) zeroed.
extern "C" int strip_walk_host(int block, const int* q, const int* t, const int* matrix,
                               int V, const int* top, const int* lbound, int* hrow,
                               unsigned long long* hand, int* sync, int* rights, int x0,
                               int y_offset, int C_real, int R_real, int del, int ext,
                               int K, int TR, int n_tr, int n_tc, int* end_out,
                               int* words, int* ckpts, int ckpt_every, int warps,
                               int blocks) {
    TileArgs a;
    a.q = q; a.t = t; a.matrix = matrix; a.top = top; a.lbound = lbound;
    a.hrow = hrow; a.hand = hand; a.rights = rights; a.end_out = end_out; a.words = words;
    a.ckpts = ckpts; a.sync = sync;
    a.width = (long long)n_tc * 32 * K;
    a.V = V; a.x0 = x0; a.y_offset = y_offset; a.C_real = C_real; a.R_real = R_real;
    a.del = del; a.ext = ext; a.TR = TR; a.n_tr = n_tr; a.n_tc = n_tc;
    a.ckpt_every = ckpt_every;
    return block ? run<true>(a, K, warps, blocks) : run<false>(a, K, warps, blocks);
}
