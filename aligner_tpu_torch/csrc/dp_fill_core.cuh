// The body of the batched fill kernel, dp_fill_kernel, and the set of its
// instances that are built (with_instance).  Included by dp_fill.cu, which
// launches it (what it replaces, what bounds it on the H100 and what the
// design does about it are set out there), and by tests/dp_fill_host.cpp,
// a host build of the same body for the CPU tests: the CUDA-only parts sit
// under __CUDACC__, and a host build supplies fill_smem() and the thread
// indices before it includes this file.
//
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
#pragma once
#include <cfloat>
#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
// the block's dynamic shared memory
__device__ __forceinline__ unsigned char* fill_smem() {
    extern __shared__ __align__(16) unsigned char fill_smem_raw[];
    return fill_smem_raw;
}
#endif

namespace dpf {

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
template <typename T, bool GLOBAL, bool TRACK, bool DIRS, bool PWM, bool PLANE>
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
    int* __restrict__ words,       // (B, R8/8, C) packed directions
    T* __restrict__ plane)         // (B, C, R8): a[y, x] at [b][x - 1][y - 1] (PLANE)
{
    unsigned char* smem_raw = fill_smem();
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
            if (PLANE) {
                // the score plane: the block's 8 values, inactive cells 0
                T* p = plane + ((long long)b * C + (x1 - 1)) * R8 + (y0 - 1);
#pragma unroll
                for (int j = 0; j < 8; ++j) p[j] = out[j];
            }
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

// The instances that are built, each named by its flags: fn(Flags<...>{})
// is called with the one the arguments select.  PWM mode is local; global
// mode always tracks (the end cell is captured there); the score plane
// comes only with directions and argmax tracking, in pair local, pair
// global and PWM mode.
template <bool G, bool TR, bool D, bool P, bool PL>
struct Flags {
    static constexpr bool GLOBAL = G, TRACK = TR, DIRS = D, PWM = P, PLANE = PL;
};

template <typename Fn>
auto with_instance(int is_pwm, int is_global, int track, int dirs, int plane, Fn&& fn) {
    if (plane) {
        if (is_pwm) return fn(Flags<false, true, true, true, true>{});
        return is_global ? fn(Flags<true, true, true, false, true>{})
                         : fn(Flags<false, true, true, false, true>{});
    }
    if (is_pwm) {
        if (track) return dirs ? fn(Flags<false, true, true, true, false>{})
                               : fn(Flags<false, true, false, true, false>{});
        return dirs ? fn(Flags<false, false, true, true, false>{})
                    : fn(Flags<false, false, false, true, false>{});
    }
    if (is_global)
        return dirs ? fn(Flags<true, true, true, false, false>{})
                    : fn(Flags<true, true, false, false, false>{});
    if (track) return dirs ? fn(Flags<false, true, true, false, false>{})
                           : fn(Flags<false, true, false, false, false>{});
    return dirs ? fn(Flags<false, false, true, false, false>{})
                : fn(Flags<false, false, false, false, false>{});
}

}  // namespace dpf
