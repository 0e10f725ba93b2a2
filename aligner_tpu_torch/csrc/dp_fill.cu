// Batched exact DP fill: pair mode (local or global) and PWM mode, scores
// only or with 2-bit packed direction words.
//
// Replaces: aligner_tpu/ops/pallas_dp.py::_kernel, launched by _run.
// * pair mode (wrappers fill_batch_pallas, fill_scores_traced and
//   fill_full_traced), both its scores-only and its direction-word
//   specialisations;
// * PWM mode, the PWM template flag (wrappers fill_pwm_batch_pallas,
//   fill_pwm_scores_traced and fill_pwm_full_traced): the rows are the
//   query, the columns the W positions of a (4, W) position-weight
//   matrix, every column is active, the mode is local, and the score of
//   cell (y, x) is pwm[q[y-1], x-1] from a shared (4, W) or per-problem
//   (B, 4, W) PWM.
//
// What bounds it on the H100: the fill is a serial recurrence inside each
// problem.  The single mutable gap penalty couples every cell to its
// predecessor in column-major order, and cell (1, x) to cell (tlen, x-1),
// so there is no parallelism inside a problem (no row striping, no
// anti-diagonals).  Each thread owns one problem and walks its cells in the
// reference's order, so a launch takes waves x cells a problem x the time
// of one cell of one warp, a wave being the problems the SMs hold at once.
// That time is the cell's dependent chain (gap terms -> two maxima -> the
// Beginning test -> the next penalty -> the next gap term) plus what the
// warp issues around it: measured 38-57 ns a cell in f32 and 53-70 ns in
// f64 on the H100, growing with the warps an SM holds (PERF.md §6).
// Device-memory traffic no longer counts: the path's shapes keep their
// columns on chip.  So a batch of one wave (the p-value, the full batch,
// the survivors) is bound by the instructions of a cell, and a batch of
// many waves (the repeat scan's 65,536 windows) also by the problems an SM
// holds, which shared memory caps at 64 for 337-row f64 columns (8 waves
// of the scan chunk).
//
// What the design does about it:
// * the column stays on chip, as the Pallas kernel keeps it in VMEM
//   scratch: rows y < S of every column live in shared memory, each warp's
//   laid out [y][lane] (a stride of 32 words the compiler knows), so the
//   32 problems of a warp touch 32 neighbouring words on every row step
//   (conflict-free in f32, two wavefronts in f64), beside the row codes of
//   those rows, one byte each, four to a word (read once at the start);
// * rows y >= S (S = 1 + 8k, so the split falls on the edge of an 8-row
//   block) live in a device buffer (R8+1-S, B) laid out [y][b].  The
//   wrapper's launch plan (ops/dp_fill.py:plan_fill) picks the warps a
//   block and S: the whole column on chip (S = R8+1, no buffer at all)
//   wherever it fits, which is every shape of the main path but the
//   tallest search buckets; then the most problems resident an SM;
// * the rows go in blocks of 8 (one direction word each) through a
//   pipeline: while a block is computed, the next block's old column
//   values and scores are loaded and the codes of the block after it, in
//   two alternating register buffers, so no load waits on the chain and no
//   score load waits on its code in the same step;
// * a shared matrix -- the (V, V) substitution matrix, or the (4, W) PWM
//   (4 x 300 x 8 B = 9.6 KB in f64) -- sits in shared memory in front of
//   the columns when it takes at most half of a block's, read through a
//   pointer the compiler knows to be shared (a generic one costs 64-bit
//   address arithmetic on every score); it is read through the L1 cache
//   otherwise (and when it is per-problem);
// * the chain is kept short: in f32 the maxima are the hardware's max
//   instruction; the argmax is taken a block at a time by a tree and once
//   a column, not compared cell by cell (a second serial chain);
// * parallelism comes only from the batch: one thread per problem, blocks
//   of 32-128 consecutive problems; a small batch gets one-warp blocks so
//   it covers as many SMs as it can.

// Exactness (bit-identical to the Pallas kernel and the XLA engine):
// * penalty := del after a Beginning cell, ext otherwise; a padded
//   (inactive) cell stores 0 and keeps the penalty; it crosses columns;
// * global borders -y*del / -x*del with the far corners -(len+1)*del;
// * ties top > left > diag by m - v < eps (FLT_EPSILON / DBL_EPSILON), and
//   m == 0 -> Beginning in local mode;
// * argmax: the first maximum in row-major order, starting from (0, 0, 0)
//   (the block tree and the column merge keep that order: a lower row wins
//   a tie inside a column, a later column only with a lower row); without
//   tracking fmax = max(bv, val) over masked values;
// * compiled with -fmad=false and without fast math.
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TOP = 0, LEFT = 1, DIAG = 2, BEG = 3;

template <typename T> struct Eps;
template <> struct Eps<float> { static __device__ float v() { return FLT_EPSILON; } };
template <> struct Eps<double> { static __device__ double v() { return DBL_EPSILON; } };

template <typename T> __device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }

// the maxima of the chain: in f32 the hardware's max instruction, one step
// where the compare-and-select takes two (equal for every value but NaN
// and a tie of +0 with -0, which compare equal); in f64 the
// compare-and-select, which is faster there than fmax
__device__ __forceinline__ float cmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double cmax(double a, double b) { return vmax(a, b); }

// rows 0..S-1 of each column live in shared memory, rows S..R8 in the
// device buffer
template <typename T, bool GLOBAL, bool TRACK, bool DIRS, bool PWM>
__global__ void dp_fill_kernel(
    const int* __restrict__ qT,    // (C, B) query codes, column chars; unused (PWM)
    const int* __restrict__ tT,    // (R8, B) row chars: target codes (pair), query codes (PWM)
    const int* __restrict__ qlen,  // (B,); unused (PWM: every column is active)
    const int* __restrict__ tlen,  // (B,)
    const T* __restrict__ mat,     // pair: (V, V) or (B, V, V); PWM: (4, C) or (B, 4, C)
    long long mat_stride,          // 0 for a shared matrix, else its size
    int mat_elems,                 // size of a shared matrix
    int smem_mat,                  // 1: copy a shared matrix to shared memory
    int V, int B, int C, int R8,
    int S,                         // rows 0..S-1 of a column on chip; S = 1 + 8k <= R8+1
    T del, T ext,
    T* __restrict__ spill,         // (R8+1-S, B): rows S..R8 of the columns; null if S = R8+1
    T* __restrict__ fmax, int* __restrict__ fy, int* __restrict__ fx,
    T* __restrict__ end,           // (B,) each
    int* __restrict__ words)       // (B, R8/8, C) packed directions
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nt = blockDim.x;
    const int lane = threadIdx.x;
    const int mat_off = smem_mat ? (mat_elems * int(sizeof(T)) + 15) & ~15 : 0;
    T* smat = reinterpret_cast<T*>(smem_raw);
    // each warp's columns, then each warp's codes: row 0 of this problem's
    // column at scol[0], row y at scol[y * 32], the codes of rows 4w+1 ..
    // 4w+4 in the bytes of scode[w * 32] (a stride the compiler knows:
    // immediate offsets)
    const int warp = lane >> 5, wl = lane & 31;
    T* scol = reinterpret_cast<T*>(smem_raw + mat_off) + (size_t)warp * S * 32 + wl;
    unsigned* scode = reinterpret_cast<unsigned*>(smem_raw + mat_off +
                                                  size_t(S) * nt * sizeof(T))
                      + (size_t)warp * ((S - 1) / 4) * 32 + wl;
    if (smem_mat) {
        for (int i = lane; i < mat_elems; i += nt) smat[i] = mat[i];
        __syncthreads();
    }
    const int b = blockIdx.x * nt + lane;
    if (b >= B) return;
    // a matrix in device memory: the shared one, or this problem's
    const T* m_b = mat_stride != 0 ? mat + (long long)b * mat_stride : mat;
    // the score of row code v in this column is m[soff + v * sstride], m
    // the matrix in shared memory (smat: 32-bit addresses the compiler
    // knows to be shared) or in device memory (m_b)
    const int sstride = PWM ? C : V;

    const int ql = PWM ? C : qlen[b];
    const int tl = tlen[b];
    const T eps = Eps<T>::v();
    const long long Bl = B;
    // row y >= S at spill_b[y * Bl]
    T* spill_b = spill != nullptr ? spill + b - (long long)S * Bl : nullptr;

    for (int w = 0; w < (S - 1) / 4; ++w) {
        unsigned word = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            word |= unsigned(tT[(long long)(4 * w + j) * Bl + b]) << (8 * j);
        scode[w * 32] = word;
    }

    // column x = 0: a[y, 0]
    auto border = [&](int y) {
        return GLOBAL ? ((y == tl) ? -(T(tl) + T(1)) * del : -T(y) * del) : T(0);
    };
    for (int y = 0; y <= R8; ++y) {
        if (y < S) scol[y * 32] = border(y);
        else spill_b[y * Bl] = border(y);
    }

    T pen = del;
    T bv = T(0), ev = T(0);
    int by = 0, bx = 0;
    const long long R8w = R8 / 8;
    int* wrow = DIRS ? words + (long long)b * R8w * C : nullptr;
    int qcode = (!PWM && C > 0) ? qT[b] : 0;

    // The rows go in blocks of 8 (one direction word each), in a pipeline:
    // while block y0 is computed, block y0+8's old column values (the left
    // neighbours) and scores are loaded, and the row codes of block y0+16;
    // so no load waits inside the block, and no load that feeds another
    // (code -> score) waits in the same step.
    //
    // the row codes in flight: an on-chip block's two code words in raw[0],
    // raw[1]; a spilled block's eight codes
    auto fetch_codes = [&](int y0, int (&raw)[8]) {
        if (y0 < S) {
            raw[0] = int(scode[((y0 - 1) >> 2) * 32]);
            raw[1] = int(scode[(((y0 - 1) >> 2) + 1) * 32]);
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) raw[j] = tT[(long long)(y0 - 1 + j) * Bl + b];
        }
    };

    for (int x1 = 1; x1 <= C; ++x1) {
        const int soff = PWM ? x1 - 1 : qcode;
        const T* srow = m_b + soff;
        if (!PWM && x1 < C) qcode = qT[(long long)x1 * Bl + b];  // the next column's
        const bool x_active = x1 <= ql;
        T border0 = T(0);
        if (GLOBAL) border0 = (x1 == ql) ? -(T(ql) + T(1)) * del : -T(x1) * del;
        T diag_prev = scol[0];
        scol[0] = border0;
        T a_up = border0;

        // the scores of the 8-row block starting at row y0, from its codes
        auto scores = [&](int y0, const int (&raw)[8], T (&sv)[8]) {
            int code[8];
            if (y0 < S) {
#pragma unroll
                for (int j = 0; j < 8; ++j) code[j] = (raw[j >> 2] >> (8 * (j & 3))) & 0xFF;
            } else {
#pragma unroll
                for (int j = 0; j < 8; ++j) code[j] = raw[j];
            }
            if (smem_mat) {
#pragma unroll
                for (int j = 0; j < 8; ++j) sv[j] = smat[soff + code[j] * sstride];
            } else {
#pragma unroll
                for (int j = 0; j < 8; ++j) sv[j] = srow[code[j] * sstride];
            }
        };
        // ... and its old values (the left neighbours)
        auto fetch_block = [&](int y0, const int (&raw)[8], T (&lv)[8], T (&sv)[8]) {
            if (y0 < S) {
#pragma unroll
                for (int j = 0; j < 8; ++j) lv[j] = scol[(y0 + j) * 32];
            } else {
#pragma unroll
                for (int j = 0; j < 8; ++j) lv[j] = spill_b[(long long)(y0 + j) * Bl];
            }
            scores(y0, raw, sv);
        };
        auto store = [&](int y0, const T (&out)[8]) {
            if (y0 < S) {
#pragma unroll
                for (int j = 0; j < 8; ++j) scol[(y0 + j) * 32] = out[j];
            } else {
#pragma unroll
                for (int j = 0; j < 8; ++j) spill_b[(long long)(y0 + j) * Bl] = out[j];
            }
        };

        // the column's first maximum so far (argmax tracking)
        T cm = T(-INFINITY);
        int cy = 0;
        // the new values of the 8-row block starting at row y0 into out
        auto compute = [&](int y0, const T (&lv)[8], const T (&sv)[8], T (&out)[8]) {
            unsigned word = 0u;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int y1 = y0 + j;
                const T left_v = lv[j];
                const T top = a_up - pen;
                const T left = left_v - pen;
                const T diag = diag_prev + sv[j];
                const T m = cmax(cmax(top, left), diag);
                const bool active = x_active && (y1 <= tl);
                const bool beg = !GLOBAL && m == T(0);
                if (DIRS) {
                    int d = (m - top < eps) ? TOP : ((m - left < eps) ? LEFT : DIAG);
                    if (beg || !active) d = BEG;
                    word |= unsigned(d) << (2 * j);
                }
                const T val = active ? m : T(0);
                if (active) pen = beg ? del : ext;
                out[j] = val;
                if (!TRACK) bv = cmax(bv, val);
                diag_prev = left_v;
                a_up = val;
            }
            if (DIRS) wrow[(long long)(y0 >> 3) * C + (x1 - 1)] = int(word);
            if (TRACK) {
                // the block's first maximum by a tree, off the chain (a lower
                // row wins a tie), then the column's; active cells only
                T best[8];
                int row[8];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    best[j] = (x_active && y0 + j <= tl) ? out[j] : T(-INFINITY);
                    row[j] = j;
                }
#pragma unroll
                for (int h = 1; h < 8; h *= 2) {
#pragma unroll
                    for (int j = 0; j < 8; j += 2 * h) {
                        const bool up = best[j + h] > best[j];
                        best[j] = up ? best[j + h] : best[j];
                        row[j] = up ? row[j + h] : row[j];
                    }
                }
                if (best[0] > cm) {
                    cm = best[0];
                    cy = y0 + row[0];
                }
                if (x1 == ql) {
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        if (y0 + j == tl) ev = out[j];
                }
            }
        };

        if (R8 > 0) {
            int raw[8];
            T lvA[8], svA[8], lvB[8], svB[8], out[8];
            fetch_codes(1, raw);
            fetch_block(1, raw, lvA, svA);
            if (9 <= R8) fetch_codes(9, raw);
            // two blocks a turn, so the buffers alternate without copies
            for (int y0 = 1; y0 <= R8; y0 += 16) {
                const bool second = y0 + 8 <= R8;
                if (second) {
                    fetch_block(y0 + 8, raw, lvB, svB);
                    if (y0 + 16 <= R8) fetch_codes(y0 + 16, raw);
                }
                compute(y0, lvA, svA, out);
                store(y0, out);
                if (second) {
                    if (y0 + 16 <= R8) {
                        fetch_block(y0 + 16, raw, lvA, svA);
                        if (y0 + 24 <= R8) fetch_codes(y0 + 24, raw);
                    }
                    compute(y0 + 8, lvB, svB, out);
                    store(y0 + 8, out);
                }
            }
        }
        // the first maximum in row-major order: a later column wins only
        // with a larger value or, on a tie, a lower row
        if (TRACK && (cm > bv || (cm == bv && cy < by))) {
            bv = cm;
            by = cy;
            bx = x1;
        }
    }
    fmax[b] = bv;
    fy[b] = TRACK ? by : 0;
    fx[b] = TRACK ? bx : 0;
    end[b] = TRACK ? ev : T(0);
}

template <typename T, bool GLOBAL, bool TRACK, bool DIRS, bool PWM>
cudaError_t launch(const int* qT, const int* tT, const int* qlen, const int* tlen,
                   const void* mat, long long mat_stride, int mat_elems, int smem_mat,
                   int V, int B, int C, int R8, int S, double del, double ext,
                   void* spill, void* fmax, int* fy, int* fx, void* end, int* words,
                   int threads, int smem, cudaStream_t stream) {
    auto kernel = dp_fill_kernel<T, GLOBAL, TRACK, DIRS, PWM>;
    // per template instance, before every launch: the most shared memory
    // and the largest carveout; a request above the card's limit is
    // refused here and reported, never run with less
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
    if (e != cudaSuccess) return e;
    const int blocks = (B + threads - 1) / threads;
    kernel<<<blocks, threads, size_t(smem), stream>>>(
        qT, tT, qlen, tlen, static_cast<const T*>(mat), mat_stride, mat_elems,
        smem_mat, V, B, C, R8, S, T(del), T(ext), static_cast<T*>(spill),
        static_cast<T*>(fmax), fy, fx, static_cast<T*>(end), words);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int is_pwm, int is_global, int track, int dirs, const int* qT,
                     const int* tT, const int* qlen, const int* tlen, const void* mat,
                     long long ms, int me, int sm, int V, int B, int C, int R8, int S,
                     double del, double ext, void* spill, void* fmax, int* fy, int* fx,
                     void* end, int* words, int threads, int smem, cudaStream_t st) {
#define DP_ARGS qT, tT, qlen, tlen, mat, ms, me, sm, V, B, C, R8, S, del, ext, spill, fmax, fy, fx, end, words, threads, smem, st
    if (is_pwm) {
        // PWM mode is local
        if (track) return dirs ? launch<T, false, true, true, true>(DP_ARGS)
                               : launch<T, false, true, false, true>(DP_ARGS);
        return dirs ? launch<T, false, false, true, true>(DP_ARGS)
                    : launch<T, false, false, false, true>(DP_ARGS);
    }
    if (is_global) {
        // global mode always tracks: the end cell is captured there
        return dirs ? launch<T, true, true, true, false>(DP_ARGS)
                    : launch<T, true, true, false, false>(DP_ARGS);
    }
    if (track) return dirs ? launch<T, false, true, true, false>(DP_ARGS)
                           : launch<T, false, true, false, false>(DP_ARGS);
    return dirs ? launch<T, false, false, true, false>(DP_ARGS)
                : launch<T, false, false, false, false>(DP_ARGS);
#undef DP_ARGS
}

}  // namespace

// is_pwm: qT and qlen are unused (pass null), mat is the (4, C) or
// (B, 4, C) PWM with V = 4, and the mode is local.  threads, S, smem_mat
// and smem come from the wrapper's launch plan; spill is null when S is
// R8 + 1.
extern "C" int dp_fill_launch(
    const void* qT, const void* tT, const void* qlen, const void* tlen,
    const void* mat, long long mat_stride, int V, int B, int C, int R8,
    double del, double ext, int is_f64, int is_pwm, int is_global, int track,
    int dirs, void* spill, void* fmax, void* fy, void* fx, void* end, void* words,
    int threads, int S, int smem_mat, int smem, void* stream) {
    cudaGetLastError();  // clear a stale error so the check below is ours
    auto st = static_cast<cudaStream_t>(stream);
    auto qi = static_cast<const int*>(qT);
    auto ti = static_cast<const int*>(tT);
    auto ql = static_cast<const int*>(qlen);
    auto tl = static_cast<const int*>(tlen);
    auto yi = static_cast<int*>(fy);
    auto xi = static_cast<int*>(fx);
    auto wi = static_cast<int*>(words);
    const int me = is_pwm ? V * C : V * V;
    cudaError_t e;
    if (is_f64)
        e = dispatch<double>(is_pwm, is_global, track, dirs, qi, ti, ql, tl, mat,
                             mat_stride, me, smem_mat, V, B, C, R8, S, del, ext, spill,
                             fmax, yi, xi, end, wi, threads, smem, st);
    else
        e = dispatch<float>(is_pwm, is_global, track, dirs, qi, ti, ql, tl, mat,
                            mat_stride, me, smem_mat, V, B, C, R8, S, del, ext, spill,
                            fmax, yi, xi, end, wi, threads, smem, st);
    return static_cast<int>(e);
}

// The card's limits the launch plan needs: out[0] SMs, out[1] the shared
// memory a block may opt in to, out[2] the shared memory of one SM, out[3]
// the shared memory the runtime keeps for each resident block.
extern "C" int dp_fill_device_limits(int dev, int* out) {
    const cudaDeviceAttr attrs[4] = {
        cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin,
        cudaDevAttrMaxSharedMemoryPerMultiprocessor, cudaDevAttrReservedSharedMemoryPerBlock};
    for (int i = 0; i < 4; ++i) {
        cudaError_t e = cudaDeviceGetAttribute(&out[i], attrs[i], dev);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
}

extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
