// The strip walk shared by the row-scan fill (wavefront.cu) and the
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
//     chunk also writes the call's right column to `rights`; every test on
//     a column is on the global column x0 + x.
//
// What it assumes of the entries: nothing but int32.  The table is read as
// int32 into shared memory; a cell forms H[y-1,x-1] + m, H - pen and their
// maximum in int32, the end cell, the rows handed down (the low half of a
// tagged word, handoff.cuh) and the checkpoint rows keep all 32 bits.  So
// any integral matrix is exact as long as every real cell and those sums
// stay within int32, which the callers' range guard keeps below 2^30
// (ops/wavefront.py:range_ok with the table's largest entry: the
// column-blocked pipeline's "lax" engine takes entries beyond int8).
// Cells of padded rows and columns may leave that range; no real cell
// reads them.
//
// What bounds it on the H100: the latency of one step of one warp.  A cell
// is a few integer operations, one of them on the chain along the row; the
// bytes are small (the call's edges, 2 bits a cell of directions when asked
// for, one H row per checkpoint).  The only parallel axis of one pair is
// the anti-diagonal, so a call's time is its critical path in steps times
// the latency of a step (the shuffle, the shared-memory loads, the chain).
//
// What the design does about it: one launch a call, a persistent grid of
// warps, never more warps than strips nor than the strips under way at once.
//   * A strip is TR rows over the call's whole width.  A warp takes strips
//     in order from an atomic ticket and walks the strip's chunks of 32*K
//     columns from left to right.  Lane l owns K neighbouring columns of a
//     chunk and keeps their H of the previous row in registers; in one step
//     it runs RS = 2 rows of them, rows 2r and 2r + 1 of chunk j at step
//     j*P + r + l, P = max(TR / 2, 32) steps a chunk, so the values it needs
//     from its left neighbour arrive by two warp shuffles a step.  (One row
//     a step spent twice the steps on the same loop overhead; four rows a
//     step, written as a loop over rows, won only the replay.)
//     Lane 31 hands its column to lane 0 of the next chunk through a
//     TR-slot ring in shared memory, P - 31 steps later: the lanes never
//     drain between chunks, only at the end of the strip.  Every lane runs
//     every step, active or not, so a step has no branch but the predicated
//     stores.
//   * Rows go down through `hand` in device memory, each value in a 64-bit
//     word with the index of the strip that may read it in its high half.
//     A lane stores its bottom-row values of a chunk as it finishes them,
//     with relaxed stores at GPU scope; the strip below reads them with
//     relaxed loads at GPU scope (L2, never the L1, which is not coherent
//     across SMs) a whole chunk ahead, and when it starts the chunk uses them
//     if every word already carried its strip's index; else the warp polls
//     the chunk's last word, backing off with __nanosleep, and reads its
//     words again.  A word is read and written whole, so the tag proves its
//     value, and no fence, flag or acquire is needed.  A strip overwrites
//     its columns of `hand` only after it has read them, so one (width,)
//     row serves.  A wait gives up after WAIT_LIMIT_CYCLES and traps: a hang
//     becomes a failed launch, never a result.
//   * A warp waits only on the strip of the previous ticket, which a running
//     warp already holds, so the schedule cannot deadlock however many
//     blocks are resident.  The block's one barrier comes before any ticket.
//   * The warps of a block share the (V, V) matrix in shared memory, loaded
//     once a block; each keeps its strip's target codes and its ring beside.
//   * A cell is H = max(max(diag + s, up - pen), left - pen), one maximum
//     on the chain along the row (Hopper's DPX add-max, __viaddmax_s32,
//     timed no faster here once a lane ran two rows a step); directions come
//     from the finished integers.  del at the pair's cell (1,1) and the end
//     cell's store are decided once a strip and tested once a step, not a
//     cell.
// A strip starts a chunk about TR / RS + 31 steps after the strip above
// started it, so a call's critical path is about
// n_tr * (TR / RS + 31) + n_tc * P steps, and about
// n_tc * P / (TR / RS + 31) strips are under way at once: the grid holds
// little more than that (plan_strips in ops/wavefront.py), so few warps
// spin.
//
// The tagged words, the relaxed load and store at GPU scope and the bounded
// wait's limit come from handoff.cuh, which the band walk shares; the
// CUDA-only primitives sit under __CUDACC__ there, and a host build of the
// body supplies its own, with the warp intrinsics it uses.
#pragma once
#include "handoff.cuh"

namespace {

constexpr int TOP = 0, LEFT = 1, DIAG = 2;
constexpr int MAX_STRIP_WARPS = 8;    // warps a block at most (the launch bounds)
constexpr int RS = 2;                 // rows a lane runs in one step
constexpr int NO_STEP = -(1 << 30);   // a step no lane reaches

struct TileArgs {
    const int* q;       // (width,) query codes of the call's columns
    const int* t;       // (rows,) target codes of the call's rows
    const int* matrix;  // (V, V) int32 scores, row = target symbol
    const int* top;     // (width,) H[y_offset, x0 + 1 ..]; unread for the border row
    const int* lbound;  // (rows + 1,) H[y_offset + r, x0]; the column-block fill only
    int* hrow;          // (width,) the call's last row, or null
    unsigned long long* hand;  // (width,) zeroed: the row handed down, tagged
    int* rights;        // (rows,) H[y_offset + r + 1, x0 + width]; the column-block fill only
    int* end_out;       // (1,) H[R_real, C_real] when the call holds it
    int* words;         // (rows / 16, width) direction words, or null
    int* ckpts;         // (rows / ckpt_every, width) checkpoint rows, or null
    int* sync;          // (1,) zeroed: the ticket
    long long width;
    int V, x0, y_offset, C_real, R_real, del, ext, TR, n_tr, n_tc, ckpt_every;
};

// Shared memory of a block: the matrix, then each warp's codes and ring.
inline size_t strip_smem_bytes(int V, int TR, int warps) {
    return sizeof(int) * (size_t(V) * V + 2 * size_t(TR) * warps);
}

// H[y, 0]: the left border with its far-corner overwrite.
__device__ __forceinline__ int border_col(int y, int R_real, int del) {
    return y == R_real ? -(R_real + 1) * del : -y * del;
}

// H[0, x]: the top border with its far-corner overwrite.
__device__ __forceinline__ int border_row(int x, int C_real, int del) {
    return x == C_real ? -(C_real + 1) * del : -x * del;
}

// My K values of the row handed down to strip `tag`, once every lane's
// words carry that tag.  The warp polls the chunk's last word, which the
// strip above writes last, one read for all lanes, backing off from 32 to
// 512 ns; then each lane reads its own words, and a word not yet tagged
// sends the warp back to the poll.
template <int K>
__device__ __forceinline__ void wait_for_row(const unsigned long long* src,
                                             const unsigned long long* last, int tag,
                                             int (&out)[K]) {
    const long long t0 = clock64();
    unsigned sleep = 32;
    for (;;) {
        const int seen = __shfl_sync(FULL, static_cast<int>(load_relaxed(last) >> 32), 0);
        if (seen == tag) {
            bool mine = true;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const unsigned long long w = load_relaxed(src + k);
                out[k] = static_cast<int>(static_cast<unsigned>(w));
                mine = mine && static_cast<int>(w >> 32) == tag;
            }
            if (__all_sync(FULL, mine)) return;
        }
        if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
        __nanosleep(sleep);
        sleep = sleep < 512 ? 2 * sleep : 512;
    }
}

// Read my K columns of a chunk's top row (tagged with the strip that may
// use them, or with 0 from the call's own top row, which needs no tag) and
// codes, starting at column xl, a period before the warp needs them.
template <int K>
__device__ __forceinline__ void read_ahead(const TileArgs& a, int i, bool top_border, int xl,
                                           unsigned long long (&pre)[K], int (&qpre)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        qpre[k] = a.q[xl + k];
        pre[k] = i > 0 ? load_relaxed(a.hand + xl + k)
                       : tagged(top_border ? border_row(xl + k + 1, a.C_real, a.del)
                                           : __ldcg(a.top + xl + k), 0);
    }
}

template <int K, bool DIRS, bool BLOCK>
__global__ void __launch_bounds__(32 * MAX_STRIP_WARPS)
fill_strips_kernel(TileArgs a) {
    int* smem = dynamic_smem();
    const int lane = threadIdx.x & 31;
    const int TR = a.TR, V = a.V, n_tc = a.n_tc;
    int* smat = smem;                                      // V * V
    int* t_s = smat + V * V + (threadIdx.x >> 5) * 2 * TR;  // TR codes of the strip
    int* ring = t_s + TR;                                  // TR: lane 31 to lane 0
    for (int k = threadIdx.x; k < V * V; k += blockDim.x) smat[k] = a.matrix[k];
    __syncthreads();  // the block's only barrier: from here on warps wait on strips alone

    const int Q = TR / RS;            // steps of a chunk's rows
    const int P = Q > 32 ? Q : 32;    // steps of one chunk
    const int CW = 32 * K;
    const int xb = BLOCK ? a.x0 : 0;  // the global column before the call's first
    const int n_steps = (n_tc - 1) * P + Q + 31;
    const int next = -a.ext;

    for (;;) {
        int i = 0;
        if (lane == 0) i = atomicAdd(a.sync, 1);
        i = __shfl_sync(FULL, i, 0);
        if (i >= a.n_tr) return;
        const int row0 = i * TR;               // first row of the strip, within the call
        const int y0 = a.y_offset + row0 + 1;  // its absolute 1-based row
        // the codes, and chunk 0's left column, which lane 0 reads from the ring
        for (int k = lane; k < TR; k += 32) {
            t_s[k] = a.t[row0 + k];
            ring[k] = BLOCK ? a.lbound[row0 + 1 + k] : border_col(y0 + k, a.R_real, a.del);
        }
        const int corner0 = BLOCK ? a.lbound[row0] : border_col(y0 - 1, a.R_real, a.del);
        const bool top_border = !BLOCK && i == 0 && a.y_offset == 0;
        // my bottom row goes to the strip below through `hand`, or, from
        // the last strip, to `hrow`
        const bool hand_down = i + 1 < a.n_tr;
        int* ck_row = nullptr;
        if (a.ckpts != nullptr && (row0 + TR) % a.ckpt_every == 0)
            ck_row = a.ckpts + (long long)((row0 + TR) / a.ckpt_every - 1) * a.width;
        // the end cell, when the strip holds it: the lane that owns its
        // column stores it at the step that finishes its row
        int end_step = NO_STEP, end_k = 0, end_row = 0;
        {
            const int ye = a.R_real - y0;
            const long long c = (long long)a.C_real - 1 - xb;
            if (ye >= 0 && ye < TR && c >= 0 && c < a.width) {
                const int je = int(c / CW), le = int(c % CW) / K;
                if (lane == le) {
                    end_step = je * P + ye / RS + le;
                    end_row = ye % RS;
                    end_k = int(c % K);
                }
            }
        }
        // the penalty of my first column in my next active step: del only
        // for lane 0's first step of the pair's first strip
        int npen0 = (i == 0 && a.y_offset == 0 && xb == 0 && lane == 0) ? -a.del : next;
        __syncwarp();

        int h[K], qk[K], topn[K], qn[K];
        unsigned dw[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            h[k] = qk[k] = qn[k] = 0;
            topn[k] = 0;
            dw[k] = 0u;
        }
        int dg0 = 0, diag_carry = 0, right0 = 0, right1 = 0;
        int r = -lane, j = 0;       // my step in my chunk (rows 2r and 2r + 1), my chunk
        int jn = 0;                 // the next chunk whose top row the warp reads
        unsigned long long pre[K];  // chunk jn's top row as read ahead
        int qpre[K];                // and its codes
        read_ahead<K>(a, i, top_border, lane * K, pre, qpre);

        // One period of P steps a chunk load: the warp takes chunk jn's top
        // row as lane 0 starts it, reads chunk jn + 1's ahead, then runs P
        // steps.  Every lane runs every step, active or not: an inactive
        // lane's cells are never read by an active one (its right neighbour
        // is inactive at the next step too, lane 0 reads the ring, and a
        // lane's chunk starts from the top row), so the step has no branch
        // but the predicated stores.
        for (int base = 0; base < n_steps; base += P) {
            if (jn < n_tc) {
                // H[y0 - 1, the column before chunk jn]: lane 31's top row of
                // the chunk before, lane 0's first diagonal
                const int corner = __shfl_sync(FULL, topn[K - 1], 31);
                const int xl = jn * CW + lane * K;
                // the row read a period ago serves if every word had its tag
                // by then; else the warp polls for it now
                bool ready = true;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    topn[k] = static_cast<int>(static_cast<unsigned>(pre[k]));
                    ready = ready && static_cast<int>(pre[k] >> 32) == i;
                    qn[k] = qpre[k];
                }
                if (!__all_sync(FULL, ready))
                    wait_for_row<K>(a.hand + xl, a.hand + jn * CW + CW - 1, i, topn);
                if (jn + 1 < n_tc) read_ahead<K>(a, i, top_border, xl + CW, pre, qpre);
                const int up_left = __shfl_up_sync(FULL, topn[K - 1], 1);
                dg0 = lane != 0 ? up_left : (jn == 0 ? corner0 : corner);
                ++jn;
            }
            const int s_end = base + P < n_steps ? base + P : n_steps;
            for (int s = base; s < s_end; ++s) {
                const bool act = static_cast<unsigned>(r) < static_cast<unsigned>(Q) &&
                                 j < n_tc;
                const int r0 = (act ? r : 0) * RS;  // the first of my two rows
                const int tc0 = t_s[r0], tc1 = t_s[r0 + 1];
                const int ring0 = ring[r0], ring1 = ring[r0 + 1];
                int li0 = __shfl_up_sync(FULL, right0, 1);
                int li1 = __shfl_up_sync(FULL, right1, 1);
                if (lane == 0) {
                    li0 = ring0;
                    li1 = ring1;
                }
                const bool first = r == 0;
                int dg = first ? dg0 : diag_carry;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    h[k] = first ? topn[k] : h[k];
                    qk[k] = first ? qn[k] : qk[k];
                    if (DIRS) dw[k] = first ? 0u : dw[k];
                }
                const int* m0 = smat + tc0 * V;
                const int* m1 = smat + tc1 * V;
                int hv0[K];
                // my first row: from the row above (h) and lane l - 1's column
                int left = li0;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const int np = k == 0 ? npen0 : next;
                    const int up = h[k];
                    const int vt = up + np;
                    const int hv = max(max(dg + m0[qk[k]], vt), left + np);
                    if (DIRS) {
                        const int vl = left + np;
                        const unsigned d = hv <= vt ? TOP : (hv <= vl ? LEFT : DIAG);
                        dw[k] |= d << (2 * (r0 & 15));
                    }
                    dg = up;
                    left = hv;
                    hv0[k] = hv;
                }
                // my second row: from my first
                left = li1;
                dg = li0;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const int up = hv0[k];
                    const int vt = up + next;
                    const int hv = max(max(dg + m1[qk[k]], vt), left + next);
                    if (DIRS) {
                        const int vl = left + next;
                        const unsigned d = hv <= vt ? TOP : (hv <= vl ? LEFT : DIAG);
                        dw[k] |= d << (2 * ((r0 + 1) & 15));
                    }
                    dg = up;
                    left = hv;
                    h[k] = hv;
                }
                npen0 = act ? next : npen0;
                right0 = hv0[K - 1];
                right1 = h[K - 1];
                if (s == end_step) {
                    int v = end_row ? h[0] : hv0[0];
#pragma unroll
                    for (int k = 1; k < K; ++k) v = k == end_k ? (end_row ? h[k] : hv0[k]) : v;
                    a.end_out[0] = v;
                }
                if (act && lane == 31) {
                    ring[r0] = right0;
                    ring[r0 + 1] = right1;
                    if (BLOCK && j == n_tc - 1) {
                        a.rights[row0 + r0] = right0;
                        a.rights[row0 + r0 + 1] = right1;
                    }
                }
                const int xl = j * CW + lane * K;
                const bool word_done = ((r0 + 1) & 15) == 15;
                if (DIRS && act && word_done) {
                    int* w = a.words + (long long)((row0 + r0) >> 4) * a.width + xl;
#pragma unroll
                    for (int k = 0; k < K; ++k) w[k] = int(dw[k]);
                }
                if (act && r0 + 1 == TR - 1) {
                    if (hand_down) {
#pragma unroll
                        for (int k = 0; k < K; ++k)
                            store_relaxed(a.hand + xl + k, tagged(h[k], i + 1));
                    } else if (a.hrow != nullptr) {
#pragma unroll
                        for (int k = 0; k < K; ++k) a.hrow[xl + k] = h[k];
                    }
                    if (ck_row != nullptr) {
#pragma unroll
                        for (int k = 0; k < K; ++k) ck_row[xl + k] = h[k];
                    }
                }
                if (DIRS && word_done) {
#pragma unroll
                    for (int k = 0; k < K; ++k) dw[k] = 0u;
                }
                diag_carry = li1;
                __syncwarp();
                const bool wrap = r + 1 == P;
                r = wrap ? 0 : r + 1;
                j += wrap;
            }
        }
        __syncwarp();
    }
}

#ifdef __CUDACC__
template <int K, bool DIRS, bool BLOCK>
cudaError_t launch_strips_k(const TileArgs& a, int warps, int blocks, size_t smem,
                            cudaStream_t st) {
    auto kern = fill_strips_kernel<K, DIRS, BLOCK>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (e != cudaSuccess) return e;
    }
    kern<<<blocks, 32 * warps, smem, st>>>(a);
    return cudaGetLastError();
}

// Fill n_tr * TR rows by n_tc * 32 * K columns in one launch of `blocks`
// blocks of `warps` warps.  Returns the CUDA error of the launch (0 on
// success) or -1 for an unsupported K or warp count.
template <bool BLOCK>
int launch_strips(TileArgs& a, int K, int warps, int blocks, cudaStream_t st) {
    cudaGetLastError();  // clear a stale error so the check below is ours
    if (warps < 1 || warps > MAX_STRIP_WARPS || blocks < 1) return -1;
    a.width = (long long)a.n_tc * 32 * K;
    const size_t smem = strip_smem_bytes(a.V, a.TR, warps);
    const bool d = a.words != nullptr;
    switch (K) {
        case 2: return int(d ? launch_strips_k<2, true, BLOCK>(a, warps, blocks, smem, st)
                             : launch_strips_k<2, false, BLOCK>(a, warps, blocks, smem, st));
        case 4: return int(d ? launch_strips_k<4, true, BLOCK>(a, warps, blocks, smem, st)
                             : launch_strips_k<4, false, BLOCK>(a, warps, blocks, smem, st));
        case 8: return int(d ? launch_strips_k<8, true, BLOCK>(a, warps, blocks, smem, st)
                             : launch_strips_k<8, false, BLOCK>(a, warps, blocks, smem, st));
        default: return -1;
    }
}

template <int K, bool DIRS, bool BLOCK>
cudaError_t occupancy_k(int warps, size_t smem, int* blocks_per_sm) {
    auto kern = fill_strips_kernel<K, DIRS, BLOCK>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (e != cudaSuccess) return e;
    }
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, 32 * warps,
                                                         smem);
}

// The blocks of `warps` warps one SM holds resident for this instance.
// Returns the CUDA error (0 on success) or -1 for an unsupported K.
template <bool BLOCK>
int strip_occupancy(int K, int dirs, int warps, int V, int TR, int* blocks_per_sm) {
    cudaGetLastError();
    if (warps < 1 || warps > MAX_STRIP_WARPS) return -1;
    const size_t smem = strip_smem_bytes(V, TR, warps);
    switch (K) {
        case 2: return int(dirs ? occupancy_k<2, true, BLOCK>(warps, smem, blocks_per_sm)
                                : occupancy_k<2, false, BLOCK>(warps, smem, blocks_per_sm));
        case 4: return int(dirs ? occupancy_k<4, true, BLOCK>(warps, smem, blocks_per_sm)
                                : occupancy_k<4, false, BLOCK>(warps, smem, blocks_per_sm));
        case 8: return int(dirs ? occupancy_k<8, true, BLOCK>(warps, smem, blocks_per_sm)
                                : occupancy_k<8, false, BLOCK>(warps, smem, blocks_per_sm));
        default: return -1;
    }
}
#endif

}  // namespace
