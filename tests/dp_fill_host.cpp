// A host build of the batched fill kernel (aligner_tpu_torch/csrc/dp_fill_core.cuh)
// for the CPU tests, on the warp emulation of tests/warp_host.h: every
// thread of a block a std::thread, the block's shared memory a vector and
// its __syncthreads a barrier.  So the kernel's own body (the columns in
// shared memory and the rows spilled past S, the 8-row pipeline, the
// direction words, the argmax tree and the score plane) runs as written,
// on the instances the library builds (dpf::with_instance), and its
// outputs are held against the plain PyTorch version.  So does the lone
// design (dp_fill_kernel_lone), as the kernel runs it and with its chain and
// companion steps in turn, column by column.
//
//     g++ -std=c++20 -O1 -pthread -shared -fPIC -I aligner_tpu_torch/csrc \
//         -o dp_fill_host.so tests/dp_fill_host.cpp
#include "warp_host.h"

inline unsigned char* fill_smem() { return reinterpret_cast<unsigned char*>(dynamic_smem()); }

#include "dp_fill_core.cuh"

namespace {

template <typename T>
int run(int is_pwm, int is_global, int track, int dirs, const int* qT, const int* tT,
        const int* qlen, const int* tlen, const void* mat, long long mat_stride, int V,
        int B, int C, int R8, double del, double ext, void* spill, void* fmax, int* fy,
        int* fx, void* end, int* words, void* plane, int threads, int S, int smem_mat,
        int smem) {
    const int me = is_pwm ? V * C : V * V;
    const int blocks = (B + threads - 1) / threads;
    return dpf::with_instance(is_pwm, is_global, track, dirs, plane != nullptr, [&](auto f) {
        using F = decltype(f);
        run_grid(threads / 32, blocks, size_t(smem + 3) / 4, [&] {
            dpf::dp_fill_kernel<T, F::GLOBAL, F::TRACK, F::DIRS, F::PWM, F::PLANE>(
                qT, tT, qlen, tlen, static_cast<const T*>(mat), mat_stride, me, smem_mat, V,
                B, C, R8, S, T(del), T(ext), static_cast<T*>(spill), static_cast<T*>(fmax),
                fy, fx, static_cast<T*>(end), words, static_cast<T*>(plane));
        }, 2);
        return 0;
    });
}

}  // namespace

// The arguments of dp_fill_launch, without the stream; the blocks run two
// at a time.
extern "C" int dp_fill_host(
    const int* qT, const int* tT, const int* qlen, const int* tlen, const void* mat,
    long long mat_stride, int V, int B, int C, int R8, double del, double ext, int is_f64,
    int is_pwm, int is_global, int track, int dirs, void* spill, void* fmax, int* fy,
    int* fx, void* end, int* words, void* plane, int threads, int S, int smem_mat,
    int smem) {
    if (threads % 32 || (plane != nullptr && !(dirs && track))) return -1;
    if (is_f64)
        return run<double>(is_pwm, is_global, track, dirs, qT, tT, qlen, tlen, mat,
                           mat_stride, V, B, C, R8, del, ext, spill, fmax, fy, fx, end,
                           words, plane, threads, S, smem_mat, smem);
    return run<float>(is_pwm, is_global, track, dirs, qT, tT, qlen, tlen, mat, mat_stride,
                      V, B, C, R8, del, ext, spill, fmax, fy, fx, end, words, plane,
                      threads, S, smem_mat, smem);
}

namespace {

// The lone design's steps in turn: the chain's column x, then the
// companion's, a schedule the kernel may also take.
template <typename T, bool G>
void lone_in_turn(const int* qT, const int* tT, const int* qlen, const int* tlen,
                  const T* mat, long long mat_stride, int smem_mat, int V, int B, int C,
                  int R8, T del, T ext, T* fmax, int* fy, int* fx, T* end, int* words) {
    dpf::LoneFill<T, G> f(qT, tlen, qlen, mat, mat_stride, smem_mat, V, B, C, R8, del, ext,
                          words);
    const int tid = int(threadIdx.x), lane = tid & 31;
    const bool chain = tid < 32;
    f.stage(tid, tT);
    __syncthreads();
    if (!chain) {
        f.start(lane);
        f.companion_column(0, lane);
    }
    __syncthreads();
    for (int x = 1; x <= f.cols; ++x) {
        if (tid == 0) f.chain_column(x);
        __syncthreads();
        if (!chain) f.companion_column(x, lane);
        __syncthreads();
    }
    if (tid == 32) f.finish(fmax, fy, fx, end);
}

template <typename T, bool G>
int run_lone(int in_turn, const int* qT, const int* tT, const int* qlen, const int* tlen,
             const T* mat, long long mat_stride, int V, int B, int C, int R8, T del, T ext,
             T* fmax, int* fy, int* fx, T* end, int* words, int smem_mat, int smem) {
    return run_grid(dpf::LONE_THREADS / 32, B, size_t(smem + 3) / 4, [&] {
        if (in_turn)
            lone_in_turn<T, G>(qT, tT, qlen, tlen, mat, mat_stride, smem_mat, V, B, C, R8, del,
                               ext, fmax, fy, fx, end, words);
        else
            dpf::dp_fill_kernel_lone<T, G>(qT, tT, qlen, tlen, mat, mat_stride, smem_mat, V, B,
                                           C, R8, del, ext, fmax, fy, fx, end, words);
    }, 4) ? 0 : -3;
}

template <typename T>
int run_lone(int is_global, int in_turn, const int* qT, const int* tT, const int* qlen,
             const int* tlen, const void* mat, long long mat_stride, int V, int B, int C,
             int R8, double del, double ext, void* fmax, int* fy, int* fx, void* end,
             int* words, int smem_mat, int smem) {
    auto run = is_global ? run_lone<T, true> : run_lone<T, false>;
    return run(in_turn, qT, tT, qlen, tlen, static_cast<const T*>(mat), mat_stride, V, B, C,
               R8, T(del), T(ext), static_cast<T*>(fmax), fy, fx, static_cast<T*>(end), words,
               smem_mat, smem);
}

}  // namespace

// The arguments of dp_fill_lone_launch, without the stream, and in_turn:
// 0 runs the kernel, 1 its steps in turn; the blocks run four at a time;
// -3 where a block wrote past its shared memory.
extern "C" int dp_fill_lone_host(
    const int* qT, const int* tT, const int* qlen, const int* tlen, const void* mat,
    long long mat_stride, int V, int B, int C, int R8, double del, double ext, int is_f64,
    int is_global, void* fmax, int* fy, int* fx, void* end, int* words, int smem_mat,
    int smem, int in_turn) {
    if (is_f64)
        return run_lone<double>(is_global, in_turn, qT, tT, qlen, tlen, mat, mat_stride, V, B,
                                C, R8, del, ext, fmax, fy, fx, end, words, smem_mat, smem);
    return run_lone<float>(is_global, in_turn, qT, tT, qlen, tlen, mat, mat_stride, V, B, C,
                           R8, del, ext, fmax, fy, fx, end, words, smem_mat, smem);
}
