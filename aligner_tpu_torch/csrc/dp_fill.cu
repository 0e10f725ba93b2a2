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
//
// What bounds a small batch with directions (the search's top 10 at B =
// 10, the population's 64 members): the launch lasts as long as its
// largest problem, whose one thread carries the chain and also does all
// else of each cell in its own instruction stream -- the score lookup, the
// tie tests and the packing of the 2-bit word, the argmax tree, the
// stores -- with nothing else on its SM to fill the gaps: 56-58 ns a cell
// in f32 and 78-94 ns in f64, where the chain alone takes 17-18 and 37-41
// (PERF.md §6).
//
// What the lone design does about it (dp_fill_kernel_lone, for the
// pair-mode fills with directions and argmax tracking of at most one
// problem an SM; ops/dp_fill.py:plan_fill picks it): a block of two warps a
// problem, the work of a cell split by role.  Lane 0 of warp 0 walks the
// active cells alone, in the reference's order and with the same
// operations, reading the old column and the scores a block of 8 rows
// ahead (16-byte shared loads) and writing the new column; warp 1 follows
// a column behind, its lanes across the rows: it recomputes each cell's
// top and left terms from the two columns (the penalty before a cell is
// derived from the previous active cell's value), packs the words, reduces
// the column's first maximum across the warp, writes the inactive cells'
// BEG words, and gathers the scores of the column after the chain's next
// from the problem's matrix in shared memory.  One barrier a column hands
// over (three column buffers and two score buffers rotate); the companion
// takes a few percent of the chain's time a column, so the chain never
// waits on it: 16.8 ns a cell in f32, 37-40 ns in f64.  The columns stay
// on chip (5 values and a code a row: about 11,000 rows in f32 and 5,600
// in f64); a taller one takes the thread-per-problem kernel.
//
// The score plane (the PLANE template flag, with directions and argmax
// tracking only; pallas_dp.py's with_scores_plane): each 8-row block's
// values are stored beside its direction word, to a (B, C, R8) plane whose
// column rows are contiguous; inactive cells hold 0.  Its consumer is one
// pair at B = 1 (keep_planes), one thread, as the reference runs one pair
// on one lane.
//
// The kernel's body and the set of its instances are dp_fill_core.cuh.
#include <cuda_runtime.h>

#include "dp_fill_core.cuh"

namespace {

template <typename T, bool GLOBAL, bool TRACK, bool DIRS, bool PWM, bool PLANE>
cudaError_t launch(const int* qT, const int* tT, const int* qlen, const int* tlen,
                   const void* mat, long long mat_stride, int mat_elems, int smem_mat,
                   int V, int B, int C, int R8, int S, double del, double ext,
                   void* spill, void* fmax, int* fy, int* fx, void* end, int* words,
                   void* plane, int threads, int smem, cudaStream_t stream) {
    auto kernel = dpf::dp_fill_kernel<T, GLOBAL, TRACK, DIRS, PWM, PLANE>;
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
        static_cast<T*>(fmax), fy, fx, static_cast<T*>(end), words, static_cast<T*>(plane));
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int is_pwm, int is_global, int track, int dirs, int with_plane,
                     const int* qT, const int* tT, const int* qlen, const int* tlen,
                     const void* mat, long long ms, int me, int sm, int V, int B, int C,
                     int R8, int S, double del, double ext, void* spill, void* fmax,
                     int* fy, int* fx, void* end, int* words, void* plane, int threads,
                     int smem, cudaStream_t st) {
    return dpf::with_instance(is_pwm, is_global, track, dirs, with_plane, [&](auto f) {
        using F = decltype(f);
        return launch<T, F::GLOBAL, F::TRACK, F::DIRS, F::PWM, F::PLANE>(
            qT, tT, qlen, tlen, mat, ms, me, sm, V, B, C, R8, S, del, ext, spill, fmax,
            fy, fx, end, words, plane, threads, smem, st);
    });
}

template <typename T, bool GLOBAL>
cudaError_t launch_lone(const int* qT, const int* tT, const int* qlen, const int* tlen,
                        const void* mat, long long mat_stride, int smem_mat, int V, int B,
                        int C, int R8, double del, double ext, void* fmax, int* fy, int* fx,
                        void* end, int* words, int smem, cudaStream_t stream) {
    auto kernel = dpf::dp_fill_kernel_lone<T, GLOBAL>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return e;
    kernel<<<B, dpf::LONE_THREADS, size_t(smem), stream>>>(
        qT, tT, qlen, tlen, static_cast<const T*>(mat), mat_stride, smem_mat, V, B, C, R8,
        T(del), T(ext), static_cast<T*>(fmax), fy, fx, static_cast<T*>(end), words);
    return cudaGetLastError();
}

}  // namespace

// is_pwm: qT and qlen are unused (pass null), mat is the (4, C) or
// (B, 4, C) PWM with V = 4, and the mode is local.  threads, S, smem_mat
// and smem come from the wrapper's launch plan; spill is null when S is
// R8 + 1.  plane: null, or the (B, C, R8) score plane (with dirs and
// track only).
extern "C" int dp_fill_launch(
    const void* qT, const void* tT, const void* qlen, const void* tlen,
    const void* mat, long long mat_stride, int V, int B, int C, int R8,
    double del, double ext, int is_f64, int is_pwm, int is_global, int track,
    int dirs, void* spill, void* fmax, void* fy, void* fx, void* end, void* words,
    void* plane, int threads, int S, int smem_mat, int smem, void* stream) {
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
    // the score plane is built only with directions and argmax tracking
    if (plane != nullptr && !(dirs && track)) return -1;
    const int with_plane = plane != nullptr;
    cudaError_t e;
    if (is_f64)
        e = dispatch<double>(is_pwm, is_global, track, dirs, with_plane, qi, ti, ql, tl,
                             mat, mat_stride, me, smem_mat, V, B, C, R8, S, del, ext,
                             spill, fmax, yi, xi, end, wi, plane, threads, smem, st);
    else
        e = dispatch<float>(is_pwm, is_global, track, dirs, with_plane, qi, ti, ql, tl,
                            mat, mat_stride, me, smem_mat, V, B, C, R8, S, del, ext,
                            spill, fmax, yi, xi, end, wi, plane, threads, smem, st);
    return static_cast<int>(e);
}

// The lone design (dp_fill_kernel_lone): a pair-mode fill with directions
// and argmax tracking, one problem a block of LONE_THREADS threads.  The
// arguments as dp_fill_launch's; smem_mat 1 copies each problem's (V, V)
// matrix to shared memory, and smem (the plan's) holds it, three columns
// and two score buffers of R8 values and R8 row codes.
extern "C" int dp_fill_lone_launch(
    const void* qT, const void* tT, const void* qlen, const void* tlen, const void* mat,
    long long mat_stride, int V, int B, int C, int R8, double del, double ext, int is_f64,
    int is_global, void* fmax, void* fy, void* fx, void* end, void* words, int smem_mat,
    int smem, void* stream) {
    cudaGetLastError();  // clear a stale error so the check below is ours
    auto st = static_cast<cudaStream_t>(stream);
    auto qi = static_cast<const int*>(qT);
    auto ti = static_cast<const int*>(tT);
    auto ql = static_cast<const int*>(qlen);
    auto tl = static_cast<const int*>(tlen);
    auto yi = static_cast<int*>(fy);
    auto xi = static_cast<int*>(fx);
    auto wi = static_cast<int*>(words);
    cudaError_t e;
    if (is_f64)
        e = is_global ? launch_lone<double, true>(qi, ti, ql, tl, mat, mat_stride, smem_mat, V,
                                                  B, C, R8, del, ext, fmax, yi, xi, end, wi,
                                                  smem, st)
                      : launch_lone<double, false>(qi, ti, ql, tl, mat, mat_stride, smem_mat,
                                                   V, B, C, R8, del, ext, fmax, yi, xi, end,
                                                   wi, smem, st);
    else
        e = is_global ? launch_lone<float, true>(qi, ti, ql, tl, mat, mat_stride, smem_mat, V,
                                                 B, C, R8, del, ext, fmax, yi, xi, end, wi,
                                                 smem, st)
                      : launch_lone<float, false>(qi, ti, ql, tl, mat, mat_stride, smem_mat, V,
                                                  B, C, R8, del, ext, fmax, yi, xi, end, wi,
                                                  smem, st);
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
