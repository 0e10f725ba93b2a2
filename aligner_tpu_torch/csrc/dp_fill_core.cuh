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

// The lone design, dp_fill_kernel_lone: one problem a block of LONE_THREADS
// threads, for the pair-mode fills with directions and argmax tracking
// (local and global) of a batch no larger than the card's SMs.  Lane 0 of
// warp 0, the chain, walks the problem's active cells (rows 1..tl of
// columns 1..ql) in the reference's order and does nothing else; warp 1,
// the companion, works one column behind with its lanes across the rows:
// from the old column and the new it recomputes each cell's top and left
// terms (the penalty before an active cell is del when the previous active
// cell in fill order held 0 in local mode, or at cell (1, 1); ext
// otherwise), packs the direction words by the same tie rule, writes the
// BEG words of the inactive cells, takes the column's first maximum by a
// warp reduction and the end cell's value, and fills the score buffer of
// the column after the chain's next.  One barrier a column hands over: the
// columns rotate through three buffers and the scores through two, so
// neither side overwrites what the other still reads.
//
// Shared memory: the problem's (V, V) matrix (smem_mat), then three
// columns and two score buffers of R8 values (row y at [y - 1]), then the
// R8 row codes, a byte each (lone_smem_bytes).
constexpr int LONE_THREADS = 64;

// eight values from and to a 16-byte-aligned address
#ifdef __CUDACC__
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 c = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = c.x, v[5] = c.y, v[6] = c.z, v[7] = c.w;
}
__device__ __forceinline__ void load8(const double* p, double (&v)[8]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const double2 a = reinterpret_cast<const double2*>(p)[j];
        v[2 * j] = a.x, v[2 * j + 1] = a.y;
    }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(double* p, const double (&v)[8]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
        reinterpret_cast<double2*>(p)[j] = make_double2(v[2 * j], v[2 * j + 1]);
}
#else
template <typename T> inline void load8(const T* p, T (&v)[8]) {
    for (int j = 0; j < 8; ++j) v[j] = p[j];
}
template <typename T> inline void store8(T* p, const T (&v)[8]) {
    for (int j = 0; j < 8; ++j) p[j] = v[j];
}
#endif

// One problem of the lone design: its block's shared memory, the chain's
// state (pen) and the companion's (the argmax and the end value).  Its
// steps for one column are chain_column and companion_column; a legal
// schedule runs chain_column(x) before companion_column(x) and
// companion_column(x - 1) before chain_column(x + 1), after start() and
// companion_column(0).
template <typename T, bool GLOBAL>
struct LoneFill {
    const int* qT;
    int B, b, C, R8, V, ql, tl;
    int cols, rows;  // the active columns and rows: ql and tl within C and R8
    T del, ext;
    const T* own;    // the problem's matrix in device memory
    const T* mat;    // the matrix read: its copy in shared memory, or own
    T* colbuf;       // column x at colbuf + (x % 3) * R8
    T* scorebuf;     // column x's scores at scorebuf + (x & 1) * R8
    unsigned char* codes;
    int* wrow;       // (R8 / 8, C) direction words
    T pen;                 // the chain's penalty
    T bv, ev; int by, bx;  // the companion's first maximum and end value

    __device__ LoneFill(const int* qT_, const int* tlen, const int* qlen, const T* mat_,
                        long long mat_stride, int smem_mat, int V_, int B_, int C_, int R8_,
                        T del_, T ext_, int* words)
        : qT(qT_), B(B_), b(int(blockIdx.x)), C(C_), R8(R8_), V(V_), del(del_), ext(ext_),
          pen(del_), bv(T(0)), ev(T(0)), by(0), bx(0) {
        ql = qlen[b];
        tl = tlen[b];
        cols = ql < 0 ? 0 : (ql < C ? ql : C);
        rows = tl < 0 ? 0 : (tl < R8 ? tl : R8);
        unsigned char* s = fill_smem();
        const long long mb = smem_mat ? ((long long)V * V * sizeof(T) + 15) & ~15ll : 0;
        own = mat_ + (long long)b * mat_stride;
        mat = smem_mat ? reinterpret_cast<T*>(s) : own;
        colbuf = reinterpret_cast<T*>(s + mb);
        scorebuf = colbuf + 3 * (long long)R8;
        codes = reinterpret_cast<unsigned char*>(scorebuf + 2 * (long long)R8);
        wrow = words + (long long)b * (R8 / 8) * C;
    }

    __device__ T* column(int x) const { return colbuf + (x % 3) * (long long)R8; }
    __device__ T* scores(int x) const { return scorebuf + (x & 1) * (long long)R8; }
    // row 0 of column x >= 1, and row y of column 0
    __device__ T border0(int x) const {
        return GLOBAL ? ((x == ql) ? -(T(ql) + T(1)) * del : -T(x) * del) : T(0);
    }
    __device__ T border(int y) const {
        return GLOBAL ? ((y == tl) ? -(T(tl) + T(1)) * del : -T(y) * del) : T(0);
    }

    // every thread of the block: the matrix, the row codes and column 0
    __device__ void stage(int tid, const int* tT) {
        if (mat != own)
            for (int i = tid; i < V * V; i += LONE_THREADS) const_cast<T*>(mat)[i] = own[i];
        T* col0 = column(0);
        for (int i = tid; i < rows; i += LONE_THREADS) {
            codes[i] = (unsigned char)tT[(long long)i * B + b];
            col0[i] = border(i + 1);
        }
    }

    // the chain: column x's active rows from column x - 1 and the scores
    __device__ void chain_column(int x) {
        const T* ob = column(x - 1);
        T* nb = column(x);
        const T* sv = scores(x);
        T a_up = border0(x);
        T diag_prev = x == 1 ? border(0) : border0(x - 1);
        auto cell = [&](T left_v, T s) {
            const T top = a_up - pen;
            const T left = left_v - pen;
            const T diag = diag_prev + s;
            const T m = cmax(cmax(top, left), diag);
            const bool beg = !GLOBAL && m == T(0);
            pen = beg ? del : ext;
            diag_prev = left_v;
            a_up = m;
            return m;
        };
        // whole 8-row blocks, the next block's loads in flight, then the rest
        const int full = rows & ~7;
        if (full > 0) {
            T lvA[8], svA[8], lvB[8], svB[8], out[8];
            load8(ob, lvA);
            load8(sv, svA);
            for (int y0 = 0; y0 < full; y0 += 16) {
                const bool second = y0 + 8 < full;
                if (second) {
                    load8(ob + y0 + 8, lvB);
                    load8(sv + y0 + 8, svB);
                }
#pragma unroll
                for (int j = 0; j < 8; ++j) out[j] = cell(lvA[j], svA[j]);
                store8(nb + y0, out);
                if (second) {
                    if (y0 + 16 < full) {
                        load8(ob + y0 + 16, lvA);
                        load8(sv + y0 + 16, svA);
                    }
#pragma unroll
                    for (int j = 0; j < 8; ++j) out[j] = cell(lvB[j], svB[j]);
                    store8(nb + y0 + 8, out);
                }
            }
        }
        for (int i = full; i < rows; ++i) nb[i] = cell(ob[i], sv[i]);
    }

    // the companion: column x's scores, mat[t[y], q[x]]
    __device__ void fill_scores(int x, int lane) {
        const T* m = mat + qT[(long long)(x - 1) * B + b];
        T* sv = scores(x);
        for (int i = lane; i < rows; i += 32) sv[i] = m[int(codes[i]) * V];
    }

    // the companion, before the first column: column 1's scores and the
    // words of the inactive columns
    __device__ void start(int lane) {
        if (cols >= 1) fill_scores(1, lane);
        for (int k = 0; k < R8 / 8; ++k)
            for (int x = cols + lane; x < C; x += 32) wrow[(long long)k * C + x] = 0xFFFF;
    }

    // the companion's step for column x: its words, its first maximum and
    // end value (x >= 1), then the scores of column x + 2
    __device__ void companion_column(int x, int lane) {
        if (x >= 1) words_column(x, lane);
        if (x + 2 <= cols) fill_scores(x + 2, lane);
    }

    __device__ void words_column(int x, int lane) {
        const T* ob = column(x - 1);
        const T* nb = column(x);
        const T eps = Eps<T>::v();
        T best = T(-INFINITY);
        int brow = 0;
        for (int k = lane; k < R8 / 8; k += 32) {
            const int y0 = 8 * k;  // rows y0 + 1 .. y0 + 8
            unsigned word = 0xFFFFu;
            if (y0 < rows) {
                // the cell above row y0 + 1 and the penalty it left
                T a_up, p;
                if (k == 0) {
                    a_up = border0(x);
                    p = (x == 1) ? del
                                 : (GLOBAL ? ext : (ob[rows - 1] == T(0) ? del : ext));
                } else {
                    a_up = nb[y0 - 1];
                    p = (!GLOBAL && a_up == T(0)) ? del : ext;
                }
                word = 0u;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int i = y0 + j;
                    int d = BEG;
                    if (i < rows) {
                        const T m = nb[i];
                        const T top = a_up - p;
                        const T left = ob[i] - p;
                        d = (m - top < eps) ? TOP : ((m - left < eps) ? LEFT : DIAG);
                        const bool beg = !GLOBAL && m == T(0);
                        if (beg) d = BEG;
                        p = beg ? del : ext;
                        a_up = m;
                        if (m > best) {
                            best = m;
                            brow = i + 1;
                        }
                    }
                    word |= unsigned(d) << (2 * j);
                }
            }
            wrow[(long long)k * C + (x - 1)] = int(word);
        }
        // the column's first maximum: a larger value, or a lower row on a tie
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const T v = __shfl_xor_sync(0xffffffffu, best, o);
            const int r = __shfl_xor_sync(0xffffffffu, brow, o);
            if (v > best || (v == best && r < brow)) {
                best = v;
                brow = r;
            }
        }
        // a later column wins only with a larger value or, on a tie, a lower row
        if (best > bv || (best == bv && brow < by)) {
            bv = best;
            by = brow;
            bx = x;
        }
        if (x == ql && rows == tl && tl > 0) ev = nb[tl - 1];
    }

    // the companion's results
    __device__ void finish(T* fmax, int* fy, int* fx, T* end) const {
        fmax[b] = bv;
        fy[b] = by;
        fx[b] = bx;
        end[b] = ev;
    }
};

template <typename T, bool GLOBAL>
__global__ void __launch_bounds__(LONE_THREADS) dp_fill_kernel_lone(
    const int* __restrict__ qT,    // (C, B) query codes, column chars
    const int* __restrict__ tT,    // (R8, B) target codes, row chars
    const int* __restrict__ qlen, const int* __restrict__ tlen,  // (B,)
    const T* __restrict__ mat,     // (V, V) or (B, V, V)
    long long mat_stride,          // 0 for a shared matrix, else its size
    int smem_mat,                  // 1: copy the problem's matrix to shared memory
    int V, int B, int C, int R8, T del, T ext,
    T* __restrict__ fmax, int* __restrict__ fy, int* __restrict__ fx, T* __restrict__ end,
    int* __restrict__ words)       // (B, R8/8, C) packed directions
{
    LoneFill<T, GLOBAL> f(qT, tlen, qlen, mat, mat_stride, smem_mat, V, B, C, R8, del, ext,
                          words);
    const int tid = threadIdx.x, lane = tid & 31;
    const bool chain = tid < 32;
    f.stage(tid, tT);
    __syncthreads();
    if (!chain) f.start(lane);
    __syncthreads();
    // column x on the chain beside the companion's column x - 1
    for (int x = 1; x <= f.cols + 1; ++x) {
        if (chain) {
            if (lane == 0 && x <= f.cols) f.chain_column(x);
        } else {
            f.companion_column(x - 1, lane);
        }
        __syncthreads();
    }
    if (tid == 32) f.finish(fmax, fy, fx, end);
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
