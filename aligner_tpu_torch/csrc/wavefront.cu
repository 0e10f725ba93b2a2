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
// The walk is one cursor, so one warp: it loads the 32 direction words
// that end at the cursor's column with one coalesced read and then moves
// inside that 16-row by 32-column window by warp shuffles, without
// touching memory, until the cursor leaves the window.
#include "wavefront_tile.cuh"

namespace {

// One cursor walks the packed words of one replayed block.  `state` holds
// (cy, cx, n): the absolute 1-based cell and the running step count; the
// block holds the rows row_base + 1 .. row_base + rows and the columns
// col_base + 1 .. col_base + C_pad, and the kernel does nothing unless the
// cursor lies inside them.  The walk leaves the block by its top or its
// left edge.
__global__ void __launch_bounds__(32)
replay_walk_kernel(const int* __restrict__ words, long long C_pad, int row_base,
                   int col_base, int rows, int* __restrict__ state,
                   int* __restrict__ steps, int budget) {
    const int lane = threadIdx.x;
    int y = state[0] - row_base;  // 1-based row within the block
    int x = state[1] - col_base;  // 1-based column within the block
    int n = state[2];
    if (y < 1 || y > rows || x < 1 || x > C_pad) return;
    unsigned cur = unsigned(steps[n >> 4]);
    // `budget` bounds the loop: a global interior holds no Beginning code,
    // so every step moves the cursor and a real walk ends far below it
    while (y > 0 && x > 0 && n < budget) {
        const int g = (y - 1) >> 4;   // word row of the window
        const int c0 = x - 32;        // 0-based column of lane 0's word
        const int c = c0 + lane;
        const int w = c >= 0 ? words[(long long)g * C_pad + c] : 0;
        while (y > 0 && x > 0 && n < budget && ((y - 1) >> 4) == g && x - 1 >= c0) {
            const int r = y - 1;
            const int d = (__shfl_sync(FULL, w, x - 1 - c0) >> ((r & 15) * 2)) & 3;
            const int sh = (n & 15) * 2;
            cur = (cur & ~(3u << sh)) | (unsigned(d) << sh);
            ++n;
            if ((n & 15) == 0) {
                if (lane == 0) steps[(n >> 4) - 1] = int(cur);
                cur = 0xffffffffu;    // the next word starts Beginning-padded
            }
            if (d == TOP || d == DIAG) --y;
            if (d == LEFT || d == DIAG) --x;
        }
    }
    if (lane == 0) {
        if ((n & 15) != 0 && n < budget) steps[n >> 4] = int(cur);
        state[0] = row_base + y;
        state[1] = col_base + x;
        state[2] = n;
    }
}

}  // namespace

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

extern "C" int wavefront_replay_walk_launch(
    const void* words, long long C_pad, int row_base, int col_base, int rows,
    void* state, void* steps, int budget, void* stream) {
    cudaGetLastError();
    replay_walk_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(words), C_pad, row_base, col_base, rows,
        static_cast<int*>(state), static_cast<int*>(steps), budget);
    return static_cast<int>(cudaGetLastError());
}
