// One column block of a global pair: the fill behind the column-blocked
// pipeline (a pair wider than one plane).
//
// Replaces: aligner_tpu/ops/wavefront.py::_kernel_block_cs (the Pallas
// kernel behind run_block_cs: the per-device step of the column-sharded
// pipeline and the replay engine of its traceback).
//
// The fill is the strip walk of wavefront_tile.cuh (what it computes, what
// bounds it on the H100 and what the design does about it are set out
// there), instantiated for a call that holds the columns x0 + 1 .. x0 + Cb
// of the pair, in one launch a call.  Nothing of the plane's borders is
// closed form here: the row above the block arrives as `h_prev` (the caller
// builds the border row for y_base = 0) and the column left of it as a
// streamed boundary, lbound[r] = H[y_base + r, x0] for r = 0 .. TR, whose
// slot 0 is the corner; a strip's first chunk reads its rows of it.  It
// returns the block's last row (the last strip's bottom row, written to
// `hrow`), its right column per row (the next block's left boundary, from
// lane 31 of each strip's last chunk), the pair's end cell when it lies in
// the block, when asked for the 2-bit directions in the row-scan fill's
// layout, and when asked for one H row every ckpt_every rows.  The TPU
// kernel evaluates a row as a max-prefix-scan over packed per-query score
// words; none of that is carried over: cells are evaluated directly and the
// scores come from the (V, V) matrix in shared memory.
#include "wavefront_tile.cuh"

// Fill TR = n_tr * TRt rows by Cb = n_tc * 32 * K columns from column x0 on
// in one launch of `blocks` blocks of `warps` warps; `hand` (Cb,) 64-bit
// words and `sync` one int, both zeroed on the launch's stream.  Returns the
// CUDA error of the launch (0 on success) or -1 for an unsupported K or warp
// count.
extern "C" int wavefront_block_cs_launch(
    const void* q, const void* t, const void* matrix, int V, const void* h_prev,
    const void* lbound, void* hrow, void* hand, void* sync, void* rights, int x0, int y_base,
    int C_real, int R_real, int del, int ext, int K, int TRt, int n_tr, int n_tc,
    void* end_out, void* words, void* ckpts, int ckpt_every, int warps, int blocks,
    void* stream) {
    TileArgs a;
    a.q = static_cast<const int*>(q);
    a.t = static_cast<const int*>(t);
    a.matrix = static_cast<const int*>(matrix);
    a.top = static_cast<const int*>(h_prev);
    a.lbound = static_cast<const int*>(lbound);
    a.hrow = static_cast<int*>(hrow);
    a.hand = static_cast<unsigned long long*>(hand);
    a.rights = static_cast<int*>(rights);
    a.end_out = static_cast<int*>(end_out);
    a.words = static_cast<int*>(words);
    a.ckpts = static_cast<int*>(ckpts);
    a.sync = static_cast<int*>(sync);
    a.V = V; a.x0 = x0; a.y_offset = y_base; a.C_real = C_real; a.R_real = R_real;
    a.del = del; a.ext = ext; a.TR = TRt; a.n_tr = n_tr; a.n_tc = n_tc;
    a.ckpt_every = ckpt_every;
    return launch_strips<true>(a, K, warps, blocks, static_cast<cudaStream_t>(stream));
}

// The blocks of `warps` warps one SM holds of the column-block fill's instance.
extern "C" int wavefront_block_cs_occupancy(int K, int dirs, int warps, int V, int TR,
                                            int* blocks_per_sm) {
    return strip_occupancy<true>(K, dirs, warps, V, TR, blocks_per_sm);
}
