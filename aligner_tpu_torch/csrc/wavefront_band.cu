// One block of a global pair by anti-diagonal steps: the band fill.
//
// Replaces: aligner_tpu/ops/wavefront.py::_kernel_band_cs (the Pallas
// band-diagonal kernel behind run_block_band, end_score_single_global_diag
// and global_end_score).
//
// What it computes, in int32.  The block is TB rows by Cb columns of
//   H[y,x] = max(H[y-1,x-1] + m[t[y], q[x]], H[y-1,x] - ext, H[y,x-1] - ext).
// Row j of the block (absolute row y_base + j + 1) is on column d - j at
// step d = 1 ... Cb + TB - 1.  Values travel in "hat" coordinates,
// hat = H + d * ext at the step d they were computed, which removes the
// penalty from the recurrence:
//   hat_d[j] = max(hat_{d-2}[j-1] + s + 2*ext, hat_{d-1}[j-1], hat_{d-1}[j]).
// Inputs are streams with one slot per step (slot k = step k + 1):
//   q   the query codes (a code >= V, the padding, scores 0);
//   f   what row 0 reads as "up": hat of the row above the block, with the
//       caller's correction for cell (1,1) in slot 0;
//   fd  what row 0 reads as "diagonal": the row above, uncorrected (row 0's
//       diagonal must not see the correction that f carries);
//   c1, c2  what row k reads on its first column, at step k + 1: the
//       diagonal and the left value from the column left of the block.
// Outputs: rb, the block's last row in hat coordinates (slot k = step
// k + 1; slots before step TB hold values of a row that has not entered
// and mean nothing); rc, the plain right column H[y_base + j + 1, Cb];
// end, the plain H at row j_end and step d_end when this block owns the
// pair's end cell.  A row that has not entered holds a large negative
// value and stays inert under max.
//
// What bounds it on the H100: the latency of one step of one warp (about
// 18 instructions at K = 2), and with many warps an SM the shared-memory
// pipe their table reads and shuffles share.  A cell is a table read, an
// add and two maxima; the bytes are the streams once.
// One pair has no batch axis: only the cells of an anti-diagonal are
// independent, and the steps of a row follow one another.
//
// What the design does about it: one launch a call, a persistent grid of
// warps, never more warps than row groups nor than the groups under way.
//   * A row group is RW = 32*K rows; lane l owns K neighbouring rows, whose
//     K cells of one step lie on one anti-diagonal and are independent.  A
//     warp takes groups in order from an atomic ticket and walks every step
//     on which its rows hold a cell, d = j0 + 1 ... j0 + RW - 1 + Cb.  All
//     lanes run the same step: the value a lane's first row needs from the
//     row above arrives by one shuffle a step, the query code that moves
//     down the rows by another; the table reads hang on the codes alone.
//     The rows' carried values (hat of the last step, and the row above's
//     of the step before) and codes stay in registers for the whole walk,
//     each code times the table's copies, so that it is a row's offset in
//     the table.
//   * The group's last row goes to the group below through `hand`, one
//     (D,) row of 64-bit words tagged with the reader's group (handoff.cuh).
//     The walk runs in chunks of P steps.  At a chunk's start the warp
//     checks the P slots it read a chunk ahead (one lane a slot), polls
//     with back-off for those not yet tagged, stages them in shared memory
//     for lane 0 (with group 0's diagonal stream fd; below group 0 the
//     diagonal is the up of the step before), writes the P values lane 31 left there in the chunk
//     before (one coalesced store of P words), and reads the next chunk's
//     slots ahead.  Writing a chunk's row only after the next chunk's slots
//     are in hand keeps the one order the single row needs: a group
//     overwrites a slot only after it has read it itself, at every chunk
//     seam too.  Slots the group above never writes (its last row right of
//     column Cb) are not waited for: they feed only cells right of Cb.
//     The last group writes `rb` in plain int32 instead.
//   * A warp waits only on the group of the previous ticket, which a
//     running warp already holds, so the schedule cannot deadlock however
//     many blocks are resident.  The block's one barrier comes before any
//     ticket.
//   * The warps of a block share the (V, V + 1) matrix in shared memory
//     (2*ext folded in, column V scoring 0), loaded once a block, in C
//     copies interleaved so that lane l reads copy l % C, which lies in the
//     banks l % C + C*i: with C = 32 the 32 lookups of a step never
//     conflict.  With one copy, a step's random lookups hit a bank three or
//     four times, and with many warps an SM the shared-memory pipe, which
//     the shuffles use too, set the pace: 32 copies halve a call at
//     262,144 x 262,144 on an H100, at 77 KB a block for BLOSUM62.  C is
//     the most copies, up to 32, with which two blocks still share an SM
//     (wavefront_band_occupancy): 32 for BLOSUM62 and DNA, fewer for a
//     larger alphabet, one where a single copy leaves room for one block.
//   * The edges (a row entering at x = 1 from c1 and c2, the right column
//     at x = Cb, the owned end cell) are decided once a chunk: the few
//     chunks that hold one run the step with the tests, every other chunk
//     runs it without.
// A group starts a chunk RW + P steps after the group above started it
// (the above group's row of that chunk is written at its next chunk's
// start), so a call's critical path is about (n_g - 1) * (RW + P) + RW +
// Cb steps, plus a row's trip through L2 a group, and about
// (RW + Cb) / (RW + P) groups are under way at once: the grid holds little
// more than that (plan_band in ops/wavefront.py), so few warps spin, or,
// where the card holds fewer warps, what it holds, and the groups go in
// rounds.
#include "handoff.cuh"

namespace {

constexpr int NEG = -(1 << 30);
constexpr int MAX_BAND_WARPS = 8;  // warps a block at most (the launch bounds)
constexpr int STEP_UNROLL = 8;     // steps of a chunk unrolled together

struct BandArgs {
    const int* t;       // (TB,) target codes of the block's rows
    const int* q;       // (D,) query-code stream
    const int* f;       // (D,) row 0's up stream
    const int* c1;      // (D,) entering rows' diagonal
    const int* c2;      // (D,) entering rows' left
    const int* fd;      // (D,) row 0's diagonal stream
    const int* matrix;  // (V, V) int32 scores, row = target symbol
    unsigned long long* hand;  // (D,) zeroed: the last row handed down, tagged
    int* sync;          // (1,) zeroed: the ticket
    int* rb;            // (D,) out, starts NEG
    int* rc;            // (TB,) out
    int* end_out;       // (1,) out, starts 0
    int V, D, Cb, ext, n_g, j_end, d_end, owned, with_rc;
    int cshift;         // the table's copies: 1 << cshift
};

// What lane 0 reads at a step: its row above and its next code, in one load.
struct alignas(8) UpCode {
    int up, q;
};

// Shared memory of a block: `copies` copies of the matrix with a column for
// the padding code, then each warp's P-slot arrays (up and code for lane 0,
// two ints a slot; its diagonal, read by group 0 only; lane 31's last row).
inline size_t band_smem_bytes(int V, int P, int warps, int copies) {
    return sizeof(int) * (size_t(copies) * V * (V + 1) + 4 * size_t(P) * warps);
}

__device__ __forceinline__ int code_at(const BandArgs& a, int i) {
    const int v = (i >= 0 && i < a.D) ? a.q[i] : a.V;
    return (v < 0 || v > a.V) ? a.V : v;
}

// n steps from step d0, lane 0 reading its row above and next code from
// uq_s (and, in group 0, its diagonal from dg_s: below it the diagonal is
// the up of the step before, which lane 0 already holds), lane 31 leaving
// its last row in out_s.
template <int K, bool EDGE, bool FIRST>
__device__ __forceinline__ void band_steps(
    const BandArgs& a, const int* smat, const UpCode* uq_s, const int* dg_s,
    int* out_s, int d0, int n, int j_first, const int (&trow)[K], const int (&c1v)[K],
    const int (&c2v)[K], int (&h)[K], int (&dg)[K], int (&qc)[K]) {
    const int lane = threadIdx.x & 31;
#pragma unroll STEP_UNROLL
    for (int s = 0; s < n; ++s) {
        const int d = d0 + s;
        int sc[K];
#pragma unroll
        for (int k = 0; k < K; ++k) sc[k] = smat[trow[k] + qc[k]];
        int up0 = __shfl_up_sync(FULL, h[K - 1], 1);
        int qx = __shfl_up_sync(FULL, qc[K - 1], 1);
        const UpCode uq = uq_s[s];
        if (lane == 0) {
            up0 = uq.up;
            qx = uq.q;
            if (FIRST) dg[0] = dg_s[s];
        }
#pragma unroll
        for (int k = K - 1; k >= 0; --k) {
            const int up = k ? h[k - 1] : up0;
            int v = dg[k] + sc[k];
            const int x = d - (j_first + k);  // this cell's column in the block
            if (EDGE && x == 1) {
                const int e = sc[k] + c1v[k];
                v = e > c2v[k] ? e : c2v[k];
            }
            const int m = h[k] > up ? h[k] : up;
            v = v > m ? v : m;
            if (EDGE) {
                if (a.with_rc && x == a.Cb) a.rc[j_first + k] = v - d * a.ext;
                if (a.owned && j_first + k == a.j_end && d == a.d_end)
                    a.end_out[0] = v - d * a.ext;
            }
            dg[k] = up;
            h[k] = v;
        }
        // the query codes move down one row
#pragma unroll
        for (int k = K - 1; k > 0; --k) qc[k] = qc[k - 1];
        qc[0] = qx;
        if (lane == 31) out_s[s] = h[K - 1];
    }
}

// One chunk's inputs for lane 0 as the warp reads them ahead, SL slots a
// lane (slot i of the chunk is step dc + i): the group above's words, or
// group 0's f and fd, and the codes.
template <int SL>
struct Ahead {
    unsigned long long w[SL];
    int fd[SL];
    int q[SL];
};

template <int P, int SL>
__device__ __forceinline__ void read_ahead(const BandArgs& a, int g, int j0, int lim, int dc,
                                           Ahead<SL>& r) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int u = 0; u < SL; ++u) {
        const int d = dc + lane + 32 * u;  // the step of my slot
        const bool mine = lane + 32 * u < P;
        r.q[u] = code_at(a, d - j0) << a.cshift;  // lane 0's code of step d + 1
        if (g == 0) {
            const bool in = mine && d - 1 < a.D;
            r.w[u] = tagged(in ? a.f[d - 1] : NEG, 0);
            r.fd[u] = in ? a.fd[d - 1] : NEG;
        } else {
            // the row above at step d - 1; a slot past the chunk or past
            // what the group above writes is not waited for
            const int slot = d - 2;
            r.w[u] = mine && slot <= lim ? load_relaxed(a.hand + slot) : tagged(NEG, g);
            r.fd[u] = NEG;
        }
    }
}

// My slots of a chunk, once each carries group g's tag: the warp polls the
// words not yet tagged, backing off from 32 to 512 ns.
template <int P, int SL>
__device__ __forceinline__ void wait_chunk(const BandArgs& a, int g, int lim, int dc,
                                           Ahead<SL>& r) {
    const int lane = threadIdx.x & 31;
    const long long t0 = clock64();
    unsigned sleep = 32;
    for (;;) {
        bool ready = true;
#pragma unroll
        for (int u = 0; u < SL; ++u) {
            const int slot = dc + lane + 32 * u - 2;
            if (word_tag(r.w[u]) != g && slot <= lim && lane + 32 * u < P) {
                r.w[u] = load_relaxed(a.hand + slot);
                ready = ready && word_tag(r.w[u]) == g;
            }
        }
        if (__all_sync(FULL, ready)) return;
        if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
        __nanosleep(sleep);
        sleep = sleep < 512 ? 2 * sleep : 512;
    }
}

template <int K, int P>
__global__ void __launch_bounds__(32 * MAX_BAND_WARPS)
band_walk_kernel(BandArgs a) {
    constexpr int RW = 32 * K;
    constexpr int SL = (P + 31) / 32;  // slots a lane reads ahead
    int* smem = dynamic_smem();
    const int lane = threadIdx.x & 31;
    const int V1 = a.V + 1, cs = a.cshift;
    // C x V x (V + 1): scores + 2*ext, column V scoring 0, entry (t, q) of
    // copy c at ((t * (V + 1) + q) << cs) + c
    const int n_tab = (a.V * V1) << cs;
    int* smat = smem;
    UpCode* uq_s = reinterpret_cast<UpCode*>(smat + n_tab + (threadIdx.x >> 5) * 4 * P);
    int* dg_s = reinterpret_cast<int*>(uq_s + P);
    int* out_s = dg_s + P;
    for (int i = threadIdx.x; i < n_tab; i += blockDim.x) {
        const int tv = (i >> cs) / V1, qv = (i >> cs) - tv * V1;
        smat[i] = (qv < a.V ? a.matrix[tv * a.V + qv] : 0) + 2 * a.ext;
    }
    __syncthreads();  // the block's only barrier: from here on warps wait on groups alone

    for (;;) {
        int g = 0;
        if (lane == 0) g = atomicAdd(a.sync, 1);
        g = __shfl_sync(FULL, g, 0);
        if (g >= a.n_g) return;
        const int j0 = g * RW;           // first row of the group
        const int j_first = j0 + lane * K;
        const int n_steps = RW - 1 + a.Cb;  // steps d = j0 + 1 ... j0 + RW - 1 + Cb
        const int n_chunks = (n_steps + P - 1) / P;
        const int lim = j0 - 2 + a.Cb;   // the last slot the group above writes
        const bool last = g == a.n_g - 1;
        // the edges' steps: rows enter up to j0 + RW, the right column from
        // j0 + Cb, the end cell at d_end when one of my rows holds it
        const bool end_here = a.owned && a.j_end >= j0 && a.j_end < j0 + RW;
        int trow[K], c1v[K], c2v[K], h[K], dg[K], qc[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int j = j_first + k;
            // my copy of row t[j]
            trow[k] = ((a.t[j] * V1) << cs) + (lane & ((1 << cs) - 1));
            c1v[k] = a.c1[j];
            c2v[k] = a.c2[j];
            h[k] = dg[k] = NEG;
            // row j reads q[d - j - 1] at step d: only row j0 has a code at
            // the first step
            qc[k] = (j == j0 ? code_at(a, 0) : a.V) << cs;
        }
        Ahead<SL> cur, nxt;
        read_ahead<P, SL>(a, g, j0, lim, j0 + 1, cur);
        for (int c = 0; c < n_chunks; ++c) {
            const int dc = j0 + 1 + c * P;
            const int n = n_steps - c * P < P ? n_steps - c * P : P;
            if (g > 0) {
                bool ready = true;
#pragma unroll
                for (int u = 0; u < SL; ++u) ready = ready && word_tag(cur.w[u]) == g;
                if (!__all_sync(FULL, ready)) wait_chunk<P, SL>(a, g, lim, dc, cur);
            }
            // the chunk before's last row, now that every slot it overwrites
            // has been read
            if (c > 0) {
                const int dp = dc - P;
#pragma unroll
                for (int u = 0; u < SL; ++u) {
                    const int i = lane + 32 * u;
                    if (i < P) {
                        if (last)
                            a.rb[dp - 1 + i] = out_s[i];
                        else
                            store_relaxed(a.hand + dp - 1 + i, tagged(out_s[i], g + 1));
                    }
                }
            }
            if (c + 1 < n_chunks) read_ahead<P, SL>(a, g, j0, lim, dc + P, nxt);
#pragma unroll
            for (int u = 0; u < SL; ++u) {
                const int i = lane + 32 * u;
                if (i < P) {
                    // the chunk in hand, staged for lane 0
                    uq_s[i] = UpCode{word_value(cur.w[u]), cur.q[u]};
                    dg_s[i] = cur.fd[u];
                }
            }
            __syncwarp();
            const int dl = dc + n - 1;
            const bool edge = dc <= j0 + RW || (a.with_rc && dl >= j0 + a.Cb) ||
                              (end_here && a.d_end >= dc && a.d_end <= dl);
            if (edge && g == 0)
                band_steps<K, true, true>(a, smat, uq_s, dg_s, out_s, dc, n, j_first, trow,
                                          c1v, c2v, h, dg, qc);
            else if (edge)
                band_steps<K, true, false>(a, smat, uq_s, dg_s, out_s, dc, n, j_first, trow,
                                           c1v, c2v, h, dg, qc);
            else if (g == 0)
                band_steps<K, false, true>(a, smat, uq_s, dg_s, out_s, dc, n, j_first, trow,
                                           c1v, c2v, h, dg, qc);
            else
                band_steps<K, false, false>(a, smat, uq_s, dg_s, out_s, dc, n, j_first,
                                            trow, c1v, c2v, h, dg, qc);
            __syncwarp();
            cur = nxt;
        }
        // the last chunk's row
        const int cl = n_chunks - 1;
        const int dp = j0 + 1 + cl * P, np = n_steps - cl * P;
#pragma unroll
        for (int u = 0; u < SL; ++u) {
            const int i = lane + 32 * u;
            if (i < np) {
                if (last)
                    a.rb[dp - 1 + i] = out_s[i];
                else
                    store_relaxed(a.hand + dp - 1 + i, tagged(out_s[i], g + 1));
            }
        }
        __syncwarp();
    }
}

// Call fn.template operator()<K, P>() for a supported shape, else return -1.
template <typename F>
int with_shape(int K, int P, F&& fn) {
#define BAND_SHAPE(k, p) \
    if (K == k && P == p) return fn.template operator()<k, p>();
    BAND_SHAPE(1, 16) BAND_SHAPE(1, 32) BAND_SHAPE(1, 64)
    BAND_SHAPE(2, 16) BAND_SHAPE(2, 32) BAND_SHAPE(2, 64)
    BAND_SHAPE(4, 16) BAND_SHAPE(4, 32) BAND_SHAPE(4, 64)
    BAND_SHAPE(8, 16) BAND_SHAPE(8, 32) BAND_SHAPE(8, 64)
#undef BAND_SHAPE
    return -1;
}

// log2 of a supported count of table copies (1, 2, 4, ... 32), else -1.
inline int copy_shift(int copies) {
    for (int cs = 0; cs <= 5; ++cs)
        if (copies == 1 << cs) return cs;
    return -1;
}

#ifdef __CUDACC__
template <int K, int P>
cudaError_t prepare(size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(band_walk_kernel<K, P>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

struct Launch {
    const BandArgs& a;
    int warps, blocks;
    size_t smem;
    cudaStream_t st;
    template <int K, int P>
    int operator()() const {
        cudaError_t e = prepare<K, P>(smem);
        if (e != cudaSuccess) return int(e);
        band_walk_kernel<K, P><<<blocks, 32 * warps, smem, st>>>(a);
        return int(cudaGetLastError());
    }
};

struct Occupancy {
    int warps;
    size_t smem;
    int* blocks_per_sm;
    template <int K, int P>
    int operator()() const {
        cudaError_t e = prepare<K, P>(smem);
        if (e != cudaSuccess) return int(e);
        return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks_per_sm, band_walk_kernel<K, P>, 32 * warps, smem));
    }
};
#endif

}  // namespace

#ifdef __CUDACC__
// Fill one block of TB = n_g * 32 * K rows over its steps in one launch of
// `blocks` blocks of `warps` warps, reading P slots ahead, with `copies`
// copies of the table a block (wavefront_band_occupancy's).  `hand` (D,)
// 64-bit words and `sync` (1,) are zeroed.  Returns the CUDA error of the
// launch (0 on success) or -1 for an unsupported K, P, warp or copy count.
extern "C" int wavefront_band_launch(
    const void* t, const void* q, const void* f, const void* c1, const void* c2,
    const void* fd, const void* matrix, int V, int TB, int D, int Cb, int ext, int K,
    int P, int j_end, int d_end, int owned, int with_rc, void* hand, void* sync, void* rb,
    void* rc, void* end_out, int warps, int blocks, int copies, void* stream) {
    cudaGetLastError();  // clear a stale error so the check below is ours
    const int cs = copy_shift(copies);
    if (warps < 1 || warps > MAX_BAND_WARPS || blocks < 1 || TB % (32 * K) || cs < 0)
        return -1;
    BandArgs a;
    a.t = static_cast<const int*>(t);
    a.q = static_cast<const int*>(q);
    a.f = static_cast<const int*>(f);
    a.c1 = static_cast<const int*>(c1);
    a.c2 = static_cast<const int*>(c2);
    a.fd = static_cast<const int*>(fd);
    a.matrix = static_cast<const int*>(matrix);
    a.hand = static_cast<unsigned long long*>(hand);
    a.sync = static_cast<int*>(sync);
    a.rb = static_cast<int*>(rb);
    a.rc = static_cast<int*>(rc);
    a.end_out = static_cast<int*>(end_out);
    a.V = V; a.D = D; a.Cb = Cb; a.ext = ext; a.n_g = TB / (32 * K);
    a.j_end = j_end; a.d_end = d_end; a.owned = owned; a.with_rc = with_rc;
    a.cshift = cs;
    return with_shape(K, P, Launch{a, warps, blocks, band_smem_bytes(V, P, warps, copies),
                                   static_cast<cudaStream_t>(stream)});
}

// How a block of `warps` warps fits on an SM of the current device for a
// V-symbol matrix: `copies` of the table, the most (up to 32) with which
// as many blocks share an SM as with one copy, or two where one copy lets
// more; the blocks an SM then holds resident (0 where not even one copy
// fits); and the block's dynamic shared memory.  Returns the CUDA error (0
// on success) or -1 for an unsupported shape.
extern "C" int wavefront_band_occupancy(int K, int P, int warps, int V, int* blocks_per_sm,
                                        int* copies, int* smem_bytes) {
    cudaGetLastError();
    if (warps < 1 || warps > MAX_BAND_WARPS) return -1;
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return int(e);
    // the blocks an SM holds with c copies
    auto fit = [&](int c, int* n) {
        const size_t smem = band_smem_bytes(V, P, warps, c);
        *n = 0;
        return smem > size_t(optin) ? 0 : with_shape(K, P, Occupancy{warps, smem, n});
    };
    int one = 0, err = fit(1, &one), c = 32, n = 0;
    const int want = one < 2 ? one : 2;
    for (; !err && c > 1; c >>= 1)
        if ((err = fit(c, &n)) || (one > 0 && n >= want)) break;
    if (err) return err;
    if (c == 1) n = one;
    *blocks_per_sm = n;
    *copies = c;
    *smem_bytes = int(band_smem_bytes(V, P, warps, c));
    return 0;
}
#endif
