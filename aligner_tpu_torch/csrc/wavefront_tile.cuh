// The tile body shared by the row-scan fill (wavefront.cu) and the
// column-block fill (wavefront_block.cu) of one global pair.
//
// What a call computes, in int32: `rows` rows of `width` columns of one
// (query, target) pair, from absolute row y_offset + 1 and column x0 + 1 on,
//   H[y,x] = max(H[y-1,x-1] + m[t[y], q[x]], H[y-1,x] - pen, H[y,x-1] - pen)
// with pen = del at the pair's cell (1,1) only and ext elsewhere; the
// direction of a cell from finished integers: TOP if H <= H[y-1,x] - pen,
// else LEFT if H <= H[y,x-1] - pen, else DIAG, packed 16 rows a word.  The
// two fills differ only in where a call's edges come from, which the
// template parameter BLOCK selects at compile time:
//   * the row-scan fill (BLOCK = false) spans the pair's width, x0 = 0: its
//     left column is the border H[y,0] = -y*del in closed form, its top row
//     the border H[0,x] = -x*del when y_offset is 0 and `top` otherwise,
//     both with the far corners H[0,C] = -(C+1)*del and H[R,0] = -(R+1)*del;
//   * the column-block fill (BLOCK = true) has no closed form inside: the
//     top row is always `top`, the left column the streamed boundary
//     `lbound`, lbound[r] = H[y_offset + r, x0], slot 0 the corner; its last
//     tile column also writes the call's right column to `rights`; every
//     test on a column is on the global column x0 + x.
//
// What bounds it on the H100: operations.  A cell is about a dozen integer
// operations on a dependent chain along the row; the bytes are small (the
// call's edges, 2 bits a cell of directions when asked for, one H row per
// checkpoint).  The only parallel axis of one pair is the anti-diagonal.
//
// What the design does about it: the call is cut into tiles of TR rows by
// 32*K columns, one warp per tile.  Lane l owns K neighbouring columns and
// keeps their H values of the previous row in registers; it runs row r at
// step r + l, so the value it needs from its left neighbour arrives by one
// warp shuffle per step and no cell waits on memory.  Tiles hand off
// through device memory: a tile reads its top row from `hrow` and its left
// column from its tile row's segment of `hcol`, and overwrites both with
// its bottom row and right column.  The left column's first slot carries
// the corner H[y0-1, first column - 1]: the tile to the left writes it from
// its own top row, so no tile reads a slot another tile of the same launch
// writes.  All tiles of one anti-diagonal of tiles are independent and run
// as one launch; a call makes n_tile_rows + n_tile_cols - 1 launches in
// stream order.  Hopper's DPX intrinsics (__viaddmax_s32) and a persistent
// grid with flags are the natural next steps and are left for later work.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TOP = 0, LEFT = 1, DIAG = 2;
constexpr unsigned FULL = 0xffffffffu;

struct TileArgs {
    const int* q;       // (width,) query codes of the call's columns
    const int* t;       // (rows,) target codes of the call's rows
    const int* matrix;  // (V, V) int32 scores, row = target symbol
    const int* top;     // (width,) H[y_offset, x0 + 1 ..]; unread for the border row
    const int* lbound;  // (rows + 1,) H[y_offset + r, x0]; the column-block fill only
    int* hrow;          // (width,) the row handed down between tiles; ends as the last row
    int* hcol;          // (n_tr, TR + 1) scratch: corner + column handed right
    int* rights;        // (rows,) H[y_offset + r + 1, x0 + width]; the column-block fill only
    int* end_out;       // (1,) H[R_real, C_real] when the call holds it
    int* words;         // (rows / 16, width) direction words, or null
    int* ckpts;         // (rows / ckpt_every, width) checkpoint rows, or null
    long long width;
    int V, x0, y_offset, C_real, R_real, del, ext, TR, n_tr, n_tc, ckpt_every;
};

// H[y, 0]: the left border with its far-corner overwrite.
__device__ __forceinline__ int border_col(int y, int R_real, int del) {
    return y == R_real ? -(R_real + 1) * del : -y * del;
}

// H[0, x]: the top border with its far-corner overwrite.
__device__ __forceinline__ int border_row(int x, int C_real, int del) {
    return x == C_real ? -(C_real + 1) * del : -x * del;
}

template <int K, bool DIRS, bool BLOCK>
__global__ void __launch_bounds__(32)
fill_tile_kernel(TileArgs a, int diag) {
    extern __shared__ int smem[];
    int* smat = smem;                  // V * V
    int* t_s = smat + a.V * a.V;       // TR
    int* col_s = t_s + a.TR;           // TR + 1

    const int lane = threadIdx.x;
    const int i_lo = diag - (a.n_tc - 1) > 0 ? diag - (a.n_tc - 1) : 0;
    const int i = i_lo + blockIdx.x;   // tile row
    const int j = diag - i;            // tile column
    const int TR = a.TR;
    const int row0 = i * TR;           // first row of the tile, within the call
    const int y0 = a.y_offset + row0 + 1;        // its absolute 1-based row
    const int xl = j * (32 * K) + lane * K;      // my first column, 0-based in the call
    const int xf = (BLOCK ? a.x0 : 0) + xl + 1;  // the same, 1-based in the pair

    for (int k = lane; k < a.V * a.V; k += 32) smat[k] = a.matrix[k];
    for (int k = lane; k < TR; k += 32) t_s[k] = a.t[row0 + k];
    int* hcol_i = a.hcol + (long long)i * (TR + 1);
    for (int k = lane; k <= TR; k += 32) {
        if (j != 0) col_s[k] = hcol_i[k];
        else if (BLOCK) col_s[k] = a.lbound[row0 + k];
        else col_s[k] = border_col(y0 - 1 + k, a.R_real, a.del);
    }

    int h[K], qk[K];
    unsigned dw[K];
    const bool top_is_border = !BLOCK && i == 0 && a.y_offset == 0;
    const int* top = i == 0 ? a.top : a.hrow;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        qk[k] = a.q[xl + k];
        h[k] = top_is_border ? border_row(xf + k, a.C_real, a.del) : top[xl + k];
        dw[k] = 0u;
    }
    __syncwarp();
    // H[y0 - 1, first column - 1]: lane 0's first diagonal (the other
    // lanes' value is overwritten below before they start)
    int diag_carry = col_s[0];
    __syncwarp();
    // the corner the tile to the right will need: this tile's top-right value
    if (lane == 31) col_s[0] = h[K - 1];
    // H of my last column in the row I finished last; before my first row
    // it is my top value, which is my right neighbour's first diagonal
    int right = h[K - 1];

    // Lane l runs row r at step r + l.  Its left neighbour finished row r
    // one step earlier, so the shuffle at the top of a step brings
    // H[y, xf - 1]; the value brought one step before is H[y - 1, xf - 1].
    for (int s = 0; s < TR + 31; ++s) {
        const int r = s - lane;
        const bool active = r >= 0 && r < TR;
        int left_in = __shfl_up_sync(FULL, right, 1);
        if (lane == 0 && active) left_in = col_s[1 + r];
        if (active) {
            const int y = y0 + r;
            const int* mrow = smat + t_s[r] * a.V;
            int left = left_in;
            int dg = diag_carry;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const int up = h[k];
                const int pen = (y == 1 && xf + k == 1) ? a.del : a.ext;
                const int vt = up - pen;
                const int vl = left - pen;
                int hv = dg + mrow[qk[k]];
                hv = hv > vt ? hv : vt;
                hv = hv > vl ? hv : vl;
                if (DIRS) {
                    const unsigned d = hv <= vt ? TOP : (hv <= vl ? LEFT : DIAG);
                    dw[k] |= d << (2 * (r & 15));
                }
                if (y == a.R_real && xf + k == a.C_real) a.end_out[0] = hv;
                dg = up;
                left = hv;
                h[k] = hv;
            }
            right = h[K - 1];
            if (lane == 31) col_s[1 + r] = right;
            if (DIRS && (r & 15) == 15) {
                int* w = a.words + (long long)((row0 + r) >> 4) * a.width + xl;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    w[k] = int(dw[k]);
                    dw[k] = 0u;
                }
            }
        }
        diag_carry = left_in;
        __syncwarp();
    }

#pragma unroll
    for (int k = 0; k < K; ++k) a.hrow[xl + k] = h[k];
    if (a.ckpts != nullptr && (row0 + TR) % a.ckpt_every == 0) {
        int* ck = a.ckpts + (long long)((row0 + TR) / a.ckpt_every - 1) * a.width;
#pragma unroll
        for (int k = 0; k < K; ++k) ck[xl + k] = h[k];
    }
    for (int k = lane; k <= TR; k += 32) hcol_i[k] = col_s[k];
    if (BLOCK && j == a.n_tc - 1)
        for (int k = lane; k < TR; k += 32) a.rights[row0 + k] = col_s[1 + k];
}

template <int K, bool BLOCK>
cudaError_t launch_tiles_k(const TileArgs& a, cudaStream_t st) {
    const size_t smem = sizeof(int) * (size_t(a.V) * a.V + 2 * size_t(a.TR) + 1);
    const bool dirs = a.words != nullptr;
    auto kd = fill_tile_kernel<K, true, BLOCK>;
    auto ks = fill_tile_kernel<K, false, BLOCK>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            dirs ? kd : ks, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (e != cudaSuccess) return e;
    }
    for (int d = 0; d < a.n_tr + a.n_tc - 1; ++d) {
        const int i_lo = d - (a.n_tc - 1) > 0 ? d - (a.n_tc - 1) : 0;
        const int i_hi = d < a.n_tr - 1 ? d : a.n_tr - 1;
        const int tiles = i_hi - i_lo + 1;
        if (dirs) kd<<<tiles, 32, smem, st>>>(a, d);
        else ks<<<tiles, 32, smem, st>>>(a, d);
    }
    return cudaGetLastError();
}

// Fill n_tr * TR rows by n_tc * 32 * K columns, one launch per anti-diagonal
// of tiles.  Returns the last CUDA error of its launches (0 on success) or
// -1 for an unsupported K.
template <bool BLOCK>
int launch_tiles(TileArgs& a, int K, cudaStream_t st) {
    cudaGetLastError();  // clear a stale error so the check below is ours
    a.width = (long long)a.n_tc * 32 * K;
    switch (K) {
        case 2: return static_cast<int>(launch_tiles_k<2, BLOCK>(a, st));
        case 4: return static_cast<int>(launch_tiles_k<4, BLOCK>(a, st));
        case 8: return static_cast<int>(launch_tiles_k<8, BLOCK>(a, st));
        default: return -1;
    }
}

}  // namespace
