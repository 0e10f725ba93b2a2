// One huge global pair: the row-scan fill and the replay walk.
//
// Replaces: aligner_tpu/ops/wavefront.py::_kernel (the Pallas row-scan
// kernel behind fill_single_global and align_single_global_chunked) and
// aligner_tpu/ops/wavefront.py::walk_tile_inner (the lax.while_loop that
// walks a replayed block inside _replay_walk_all).
//
// The fill is the strip walk of wavefront_tile.cuh (what it computes, what
// bounds it on the H100 and what the design does about it are set out
// there), instantiated for a call that spans the pair's width: the left
// column and, from row 0, the top row are the plane's borders in closed
// form.  One launch a call: the warps take the call's strips of TR rows by
// ticket and hand rows down through one (C_pad,) row of tagged words.  The TPU kernel evaluates a whole row as a max-prefix-scan;
// none of that is carried over: integers give the same bits in any order,
// so the kernel evaluates cells directly.
//
// The walk is one cursor, so one warp, one launch a call: the walker core of
// walk_core.cuh (what bounds it and what the design does about it are set
// out there), 16 rows a word, REPLAY_DEPTH word rows staged ahead of the
// cursor.
#include "walk_core.cuh"
#include "wavefront_tile.cuh"

// Fill R_pad = n_tr * TR rows by C_pad = n_tc * 32 * K columns in one
// launch of `blocks` blocks of `warps` warps; `hand` (C_pad,) 64-bit words
// and `sync` one int, both zeroed on the launch's stream.  Returns the CUDA
// error of the launch (0 on success) or -1 for an unsupported K or warp
// count.
extern "C" int wavefront_row_scan_launch(
    const void* q, const void* t, const void* matrix, int V, const void* h0,
    void* hand, void* sync, int y_offset, int C_real, int R_real, int del, int ext,
    int K, int TR, int n_tr, int n_tc, void* end_out, void* words, void* ckpts,
    int ckpt_every, int warps, int blocks, void* stream) {
    TileArgs a;
    a.q = static_cast<const int*>(q);
    a.t = static_cast<const int*>(t);
    a.matrix = static_cast<const int*>(matrix);
    a.top = static_cast<const int*>(h0);
    a.lbound = nullptr;
    a.hrow = nullptr;
    a.hand = static_cast<unsigned long long*>(hand);
    a.rights = nullptr;
    a.end_out = static_cast<int*>(end_out);
    a.words = static_cast<int*>(words);
    a.ckpts = static_cast<int*>(ckpts);
    a.sync = static_cast<int*>(sync);
    a.V = V; a.x0 = 0; a.y_offset = y_offset; a.C_real = C_real; a.R_real = R_real;
    a.del = del; a.ext = ext; a.TR = TR; a.n_tr = n_tr; a.n_tc = n_tc;
    a.ckpt_every = ckpt_every;
    return launch_strips<false>(a, K, warps, blocks, static_cast<cudaStream_t>(stream));
}

// The blocks of `warps` warps one SM holds of the row-scan fill's instance.
extern "C" int wavefront_row_scan_occupancy(int K, int dirs, int warps, int V, int TR,
                                            int* blocks_per_sm) {
    return strip_occupancy<false>(K, dirs, warps, V, TR, blocks_per_sm);
}

// The replay walk over a block's words with a ring of walk::REPLAY_DEPTH
// word rows of `span` columns, copied 16 bytes at a time where the words
// allow it; `stats` null or three ints the walk adds its rows asked for, its
// refills and its rounds to.  Returns the CUDA error of the launch (0 on
// success) or -1 for an unsupported span.
extern "C" int wavefront_replay_walk_launch(
    const void* words, long long C_pad, int row_base, int col_base, int rows,
    void* state, void* steps, int budget, int span, void* stats, void* stream) {
    cudaGetLastError();
    if (span < 4) return -1;
    const bool vec = C_pad % 4 == 0 && span % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(words) % 16 == 0;
    const size_t smem = sizeof(int) * size_t(walk::ring_ints(walk::REPLAY_DEPTH, span));
    auto kernel = vec ? replay_walk_kernel<4> : replay_walk_kernel<1>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(words), C_pad, row_base, col_base, rows,
        static_cast<int*>(state), static_cast<int*>(steps), budget, span,
        static_cast<int*>(stats));
    return static_cast<int>(cudaGetLastError());
}
