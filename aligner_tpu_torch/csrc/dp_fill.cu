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
// anti-diagonals).  Each thread therefore owns one problem and walks its
// cells in the reference's order; the bound is the latency of the per-cell
// dependent chain (max -> penalty -> next max), plus the column buffer's
// memory traffic once a large batch no longer fits in L2.
//
// What the design does about it:
// * parallelism comes only from the batch: one thread per problem, blocks
//   of consecutive problems, the block size picked by the wrapper so a
//   batch of a few thousand still covers all 132 SMs;
// * the column buffer (R8+1, B) lives in device memory laid out [y][b],
//   and the target codes come transposed to (R8, B), so the 32 threads of
//   a warp touch 32 neighbouring words on every row step (coalesced);
// * a thread walks its column in blocks of 8 rows (one direction word
//   each) and issues the loads of the next block before it computes this
//   one: with few warps per SM (a 4,999-problem batch gives ~1 warp per
//   SM) nothing else hides the memory latency of the column buffer;
// * a shared matrix -- the (V, V) substitution matrix, or the (4, W) PWM
//   (4 x 300 x 8 B = 9.6 KB in f64) -- sits in shared memory; above
//   48 KB the launch opts in to Hopper's larger dynamic shared memory,
//   and a matrix too large even for that (or a per-problem one) is read
//   through the L1 cache instead;
// * the penalty, the running best and the end cell stay in registers for
//   the whole fill.
//
// Exactness (bit-identical to the Pallas kernel and the XLA engine):
// * penalty := del after a Beginning cell, ext otherwise; a padded
//   (inactive) cell stores 0 and keeps the penalty; it crosses columns;
// * global borders -y*del / -x*del with the far corners -(len+1)*del;
// * ties top > left > diag by m - v < eps (FLT_EPSILON / DBL_EPSILON), and
//   m == 0 -> Beginning in local mode;
// * argmax: the first maximum in row-major order, starting from (0, 0, 0);
//   without tracking fmax = max(bv, val) over masked values;
// * compiled with -fmad=false and without fast math.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TOP = 0, LEFT = 1, DIAG = 2, BEG = 3;

template <typename T> struct Eps;
template <> struct Eps<float> { static __device__ float v() { return FLT_EPSILON; } };
template <> struct Eps<double> { static __device__ double v() { return DBL_EPSILON; } };

template <typename T> __device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }

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
    int V, int B, int C, int R8, T del, T ext,
    T* __restrict__ col,           // (R8+1, B) column buffer
    T* __restrict__ fmax, int* __restrict__ fy, int* __restrict__ fx,
    T* __restrict__ end,           // (B,) each
    int* __restrict__ words)       // (B, R8/8, C) packed directions
{
    extern __shared__ unsigned char smem_raw[];
    T* smat = reinterpret_cast<T*>(smem_raw);
    if (mat_stride == 0 && smem_mat) {
        for (int i = threadIdx.x; i < mat_elems; i += blockDim.x) smat[i] = mat[i];
        __syncthreads();
    }
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const T* m_b = mat_stride != 0 ? mat + (long long)b * mat_stride
                                   : (smem_mat ? smat : mat);
    // the score of row code v in this column is srow[v * sstride]
    const int sstride = PWM ? C : V;

    const int ql = PWM ? C : qlen[b];
    const int tl = tlen[b];
    const T eps = Eps<T>::v();
    const long long Bl = B;

    // column x = 0: a[y, 0]
    for (int y = 0; y <= R8; ++y) {
        T v = T(0);
        if (GLOBAL) v = (y == tl) ? -(T(tl) + T(1)) * del : -T(y) * del;
        col[(long long)y * Bl + b] = v;
    }

    T pen = del;
    T bv = T(0), ev = T(0);
    int by = 0, bx = 0;
    const long long R8w = R8 / 8;
    int* wrow = DIRS ? words + (long long)b * R8w * C : nullptr;

    for (int x1 = 1; x1 <= C; ++x1) {
        const T* srow = PWM ? m_b + (x1 - 1) : m_b + qT[(long long)(x1 - 1) * Bl + b];
        const bool x_active = x1 <= ql;
        T border0 = T(0);
        if (GLOBAL) border0 = (x1 == ql) ? -(T(ql) + T(1)) * del : -T(x1) * del;
        T diag_prev = col[b];
        col[b] = border0;
        T a_up = border0;
        // rows go in blocks of 8 (one direction word each); the next
        // block's column values and target codes are loaded before this
        // block is computed, so their latency overlaps the serial chain
        T lv[8];
        int ty[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            lv[j] = col[(long long)(1 + j) * Bl + b];
            ty[j] = tT[(long long)j * Bl + b];
        }
        for (int y0 = 1; y0 <= R8; y0 += 8) {
            T nlv[8] = {};
            int nty[8] = {};
            if (y0 + 8 <= R8) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    nlv[j] = col[(long long)(y0 + 8 + j) * Bl + b];
                    nty[j] = tT[(long long)(y0 + 7 + j) * Bl + b];
                }
            }
            unsigned word = 0u;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int y1 = y0 + j;
                const T left_v = lv[j];
                const T s = srow[ty[j] * sstride];
                const T top = a_up - pen;
                const T left = left_v - pen;
                const T diag = diag_prev + s;
                const T m = vmax(vmax(top, left), diag);
                const bool active = x_active && (y1 <= tl);
                const bool beg = !GLOBAL && m == T(0);
                if (DIRS) {
                    int d = (m - top < eps) ? TOP : ((m - left < eps) ? LEFT : DIAG);
                    if (beg || !active) d = BEG;
                    word |= unsigned(d) << (2 * j);
                }
                const T val = active ? m : T(0);
                if (active) pen = beg ? del : ext;
                col[(long long)y1 * Bl + b] = val;
                if (TRACK) {
                    if (active && (m > bv || (m == bv && y1 < by))) {
                        bv = m; by = y1; bx = x1;
                    }
                    if (active && y1 == tl && x1 == ql) ev = m;
                } else {
                    bv = vmax(bv, val);
                }
                diag_prev = left_v;
                a_up = val;
            }
            if (DIRS) wrow[(long long)(y0 >> 3) * C + (x1 - 1)] = int(word);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                lv[j] = nlv[j];
                ty[j] = nty[j];
            }
        }
    }
    fmax[b] = bv;
    fy[b] = TRACK ? by : 0;
    fx[b] = TRACK ? bx : 0;
    end[b] = TRACK ? ev : T(0);
}

template <typename T, bool GLOBAL, bool TRACK, bool DIRS, bool PWM>
cudaError_t launch(const int* qT, const int* tT, const int* qlen, const int* tlen,
                   const void* mat, long long mat_stride, int mat_elems, int V,
                   int B, int C, int R8, double del, double ext, void* col,
                   void* fmax, int* fy, int* fx, void* end, int* words,
                   int threads, cudaStream_t stream) {
    auto kernel = dp_fill_kernel<T, GLOBAL, TRACK, DIRS, PWM>;
    size_t smem = 0;
    int smem_mat = 0;
    if (mat_stride == 0) {
        int dev = 0, optin = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e != cudaSuccess) return e;
        const size_t bytes = sizeof(T) * size_t(mat_elems);
        if (bytes <= size_t(optin)) {
            smem = bytes;
            smem_mat = 1;
            if (bytes > 48 * 1024) {
                e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
                if (e != cudaSuccess) return e;
            }
        }
    }
    const int blocks = (B + threads - 1) / threads;
    kernel<<<blocks, threads, smem, stream>>>(
        qT, tT, qlen, tlen, static_cast<const T*>(mat), mat_stride, mat_elems,
        smem_mat, V, B, C, R8, T(del), T(ext), static_cast<T*>(col),
        static_cast<T*>(fmax), fy, fx, static_cast<T*>(end), words);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int is_pwm, int is_global, int track, int dirs, const int* qT,
                     const int* tT, const int* qlen, const int* tlen, const void* mat,
                     long long ms, int me, int V, int B, int C, int R8, double del,
                     double ext, void* col, void* fmax, int* fy, int* fx, void* end,
                     int* words, int threads, cudaStream_t st) {
#define DP_ARGS qT, tT, qlen, tlen, mat, ms, me, V, B, C, R8, del, ext, col, fmax, fy, fx, end, words, threads, st
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
// (B, 4, C) PWM with V = 4, and the mode is local.
extern "C" int dp_fill_launch(
    const void* qT, const void* tT, const void* qlen, const void* tlen,
    const void* mat, long long mat_stride, int V, int B, int C, int R8,
    double del, double ext, int is_f64, int is_pwm, int is_global, int track,
    int dirs, void* col, void* fmax, void* fy, void* fx, void* end, void* words,
    int threads, void* stream) {
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
                             mat_stride, me, V, B, C, R8, del, ext, col, fmax, yi, xi,
                             end, wi, threads, st);
    else
        e = dispatch<float>(is_pwm, is_global, track, dirs, qi, ti, ql, tl, mat,
                            mat_stride, me, V, B, C, R8, del, ext, col, fmax, yi, xi,
                            end, wi, threads, st);
    return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
