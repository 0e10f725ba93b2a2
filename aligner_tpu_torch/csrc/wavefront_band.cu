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
// What bounds it on the H100: operations, and more exactly latency.  A cell
// is a table read, an add and two maxima; the bytes are the streams once.
// One pair has no batch axis: only the cells of an anti-diagonal are
// independent, and the steps of a row follow one another.
//
// What the design does about it: the block is cut into tiles of 32*K rows
// by TD steps, one warp each.  A lane owns K neighbouring rows, whose K
// cells of one step are independent of each other (they lie on one
// anti-diagonal), so a lane has K chains to overlap where the row-scan
// kernel's lane has one.  All lanes run the same step: the value a lane's
// first row needs from the row above arrives by one shuffle a step, the
// query code that moves down the rows by another; the table reads hang on
// the codes alone, not on the chain of maxima.  A tile keeps its rows' two
// carried values (hat of the last step, and the row above's of the
// step before) in registers and parks them in `state` between tiles.  Row
// groups hand off through one stream buffer `w`: tile (g, c) reads chunk c,
// which tile (g-1, c) wrote one launch earlier, and overwrites it with its
// own last row; the two slots before the chunk, which tile (g, c-1) has
// already overwritten, are passed on in `carry`.  The tiles with
// g + c = const are independent and run as one launch; launches follow in
// stream order.  Tiles that lie wholly left of column 0 or right of column
// Cb are not launched, so a block as tall as the whole pair costs no more
// than its cells.  None of the TPU kernel's (S, 128) tiles, 512-slot SMEM
// chunks, unrolling or packed score table is carried over.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NEG = -(1 << 30);
constexpr int STEP_UNROLL = 4;  // steps of a tile unrolled together

struct BandArgs {
    const int* t;       // (TB,) target codes of the block's rows
    const int* q;       // (D,) query-code stream
    const int* f;       // (D,) row 0's up stream
    const int* c1;      // (D,) entering rows' diagonal
    const int* c2;      // (D,) entering rows' left
    const int* fd;      // (D,) row 0's diagonal stream
    const int* matrix;  // (V, V) int32 scores, row = target symbol
    int* state;         // (2, TB) scratch, starts NEG: hat of the last step; the
                        // row above's hat of the step before
    int* carry;         // (n_g, 2) scratch, starts NEG: the two slots before a chunk
    int* w;             // (D,) scratch, starts NEG: the stream between row groups
    int* rb;            // (D,) out, starts NEG
    int* rc;            // (TB,) out
    int* end_out;       // (1,) out, starts 0
    int V, TB, D, Cb, ext, TD, n_g, n_c, j_end, d_end, owned, with_rc;
};

template <int K, bool EDGE>
__device__ __forceinline__ void band_steps(
    const BandArgs& a, const int* smat, const int* q_s, const int* up_s,
    const int* dg_s, int* out_s, int k0, int j_first, const int (&trow)[K],
    const int (&c1v)[K], const int (&c2v)[K], int (&h)[K], int (&dg)[K], int (&qc)[K]) {
    const int lane = threadIdx.x;
#pragma unroll STEP_UNROLL
    for (int s = 0; s < a.TD; ++s) {
        const int d = k0 + s + 1;
        int sc[K];
#pragma unroll
        for (int k = 0; k < K; ++k) sc[k] = smat[trow[k] + qc[k]];
        int up0 = __shfl_up_sync(FULL, h[K - 1], 1);
        int qx = __shfl_up_sync(FULL, qc[K - 1], 1);
        if (lane == 0) {
            up0 = up_s[s];
            qx = q_s[s + 1];
            dg[0] = dg_s[s];
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

template <int K>
__global__ void __launch_bounds__(32)
band_tile_kernel(BandArgs a, int diag, int g_lo) {
    extern __shared__ int smem[];
    const int V1 = a.V + 1;
    int* smat = smem;            // V * (V + 1): scores + 2*ext, column V scores 0
    int* q_s = smat + a.V * V1;  // TD + 1: the first row's codes, one step ahead
    int* up_s = q_s + a.TD + 1;  // TD
    int* dg_s = up_s + a.TD;     // TD
    int* out_s = dg_s + a.TD;    // TD

    const int lane = threadIdx.x;
    const int g = g_lo + blockIdx.x;  // row group
    const int c = diag - g;           // step chunk
    const int RW = 32 * K;
    const int k0 = c * a.TD;          // first slot of the chunk
    const int j0 = g * RW;            // first row of the group
    const int j_first = j0 + lane * K;

    for (int i = lane; i < a.V * V1; i += 32) {
        const int tv = i / V1, qv = i - tv * V1;
        smat[i] = (qv < a.V ? a.matrix[tv * a.V + qv] : 0) + 2 * a.ext;
    }
    const int* cg = a.carry + 2 * g;
    for (int s = lane; s <= a.TD; s += 32) {
        // the group's first row is on column k0 + s + 1 - j0 at step k0 + s + 1
        const int kq = k0 + s - j0;
        const int qv = (kq >= 0 && kq < a.D) ? a.q[kq] : a.V;
        q_s[s] = (qv < 0 || qv > a.V) ? a.V : qv;
    }
    for (int s = lane; s < a.TD; s += 32) {
        const int kk = k0 + s;
        const bool in = kk < a.D;
        if (g == 0) {
            up_s[s] = in ? a.f[kk] : NEG;
            dg_s[s] = in ? a.fd[kk] : NEG;
        } else {
            // slot kk - 1 and kk - 2 of the stream the group above wrote
            up_s[s] = s >= 1 ? (kk - 1 < a.D ? a.w[kk - 1] : NEG) : cg[1];
            dg_s[s] = s >= 2 ? (kk - 2 < a.D ? a.w[kk - 2] : NEG) : cg[s];
        }
    }
    // the chunk's last slot: the tile of the next chunk needs it, and this
    // tile overwrites it below
    const int last_slot = k0 + a.TD - 1;
    const int last_in = (g > 0 && last_slot < a.D) ? a.w[last_slot] : NEG;

    int trow[K], c1v[K], c2v[K], h[K], dg[K], qc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int j = j_first + k;
        trow[k] = a.t[j] * V1;
        c1v[k] = a.c1[j];
        c2v[k] = a.c2[j];
        h[k] = a.state[j];
        dg[k] = a.state[a.TB + j];
        // the code row j reads at the chunk's first step: q of column k0 + 1 - j
        const int qi = k0 - j;
        int qv = (qi >= 0 && qi < a.D) ? a.q[qi] : a.V;
        qc[k] = (qv < 0 || qv > a.V) ? a.V : qv;
    }
    __syncwarp();

    // columns the tile covers: its last row at its first step up to its
    // first row at its last step
    const int x_lo = k0 + 1 - (j0 + RW - 1), x_hi = k0 + a.TD - j0;
    const int x_end = a.d_end - a.j_end;
    const bool edge = x_lo <= 1 || (a.with_rc && x_lo <= a.Cb && a.Cb <= x_hi)
                      || (a.owned && x_lo <= x_end && x_end <= x_hi);
    if (edge)
        band_steps<K, true>(a, smat, q_s, up_s, dg_s, out_s, k0, j_first, trow, c1v, c2v,
                            h, dg, qc);
    else
        band_steps<K, false>(a, smat, q_s, up_s, dg_s, out_s, k0, j_first, trow, c1v,
                             c2v, h, dg, qc);

#pragma unroll
    for (int k = 0; k < K; ++k) {
        a.state[j_first + k] = h[k];
        a.state[a.TB + j_first + k] = dg[k];
    }
    __syncwarp();
    if (g > 0 && lane == 0) {
        // slots k0 + TD - 2 and k0 + TD - 1 of the group above's stream
        a.carry[2 * g] = up_s[a.TD - 1];
        a.carry[2 * g + 1] = last_in;
    }
    int* out = g == a.n_g - 1 ? a.rb : a.w;
    for (int s = lane; s < a.TD; s += 32)
        if (k0 + s < a.D) out[k0 + s] = out_s[s];
}

template <int K>
cudaError_t launch_band(const BandArgs& a, cudaStream_t st, int* n_launched) {
    const size_t smem = sizeof(int) * (size_t(a.V) * (a.V + 1) + 4 * size_t(a.TD) + 1);
    auto kern = band_tile_kernel<K>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (e != cudaSuccess) return e;
    }
    const long long RW = 32 * K, TD = a.TD, span = TD + RW;
    int n = 0;
    for (long long dgn = 0; dgn < a.n_g + a.n_c - 1; ++dgn) {
        long long g_lo = dgn - (a.n_c - 1) > 0 ? dgn - (a.n_c - 1) : 0;
        long long g_hi = dgn < a.n_g - 1 ? dgn : a.n_g - 1;
        // a tile (g, c = dgn - g) runs unless it lies wholly left of column
        // 0, (c + 1) * TD < g * RW, or wholly right of column Cb,
        // c * TD + 2 - (g + 1) * RW > Cb
        const long long hi = ((dgn + 1) * TD) / span;
        const long long num = dgn * TD + 2 - RW - a.Cb;
        const long long lo = num > 0 ? (num + span - 1) / span : 0;
        if (hi < g_hi) g_hi = hi;
        if (lo > g_lo) g_lo = lo;
        if (g_lo > g_hi) continue;
        kern<<<int(g_hi - g_lo + 1), 32, smem, st>>>(a, int(dgn), int(g_lo));
        ++n;
    }
    *n_launched = n;
    return cudaGetLastError();
}

}  // namespace

// Fill one block of TB = n_g * 32 * K rows over D steps in tiles of TD
// steps.  Returns the last CUDA error of its launches (0 on success) or -1
// for an unsupported K; `n_launched` receives the number of kernel launches.
extern "C" int wavefront_band_launch(
    const void* t, const void* q, const void* f, const void* c1, const void* c2,
    const void* fd, const void* matrix, int V, int TB, int D, int Cb, int ext,
    int K, int TD, int j_end, int d_end, int owned, int with_rc, void* state,
    void* carry, void* w, void* rb, void* rc, void* end_out, int* n_launched,
    void* stream) {
    cudaGetLastError();  // clear a stale error so the check below is ours
    BandArgs a;
    a.t = static_cast<const int*>(t);
    a.q = static_cast<const int*>(q);
    a.f = static_cast<const int*>(f);
    a.c1 = static_cast<const int*>(c1);
    a.c2 = static_cast<const int*>(c2);
    a.fd = static_cast<const int*>(fd);
    a.matrix = static_cast<const int*>(matrix);
    a.state = static_cast<int*>(state);
    a.carry = static_cast<int*>(carry);
    a.w = static_cast<int*>(w);
    a.rb = static_cast<int*>(rb);
    a.rc = static_cast<int*>(rc);
    a.end_out = static_cast<int*>(end_out);
    a.V = V; a.TB = TB; a.D = D; a.Cb = Cb; a.ext = ext; a.TD = TD;
    a.n_g = TB / (32 * K); a.n_c = (D + TD - 1) / TD;
    a.j_end = j_end; a.d_end = d_end; a.owned = owned; a.with_rc = with_rc;
    auto st = static_cast<cudaStream_t>(stream);
    *n_launched = 0;
    cudaError_t e;
    switch (K) {
        case 1: e = launch_band<1>(a, st, n_launched); break;
        case 2: e = launch_band<2>(a, st, n_launched); break;
        case 4: e = launch_band<4>(a, st, n_launched); break;
        case 8: e = launch_band<8>(a, st, n_launched); break;
        default: return -1;
    }
    return static_cast<int>(e);
}
