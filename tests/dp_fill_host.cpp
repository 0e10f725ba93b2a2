// A host build of the batched fill kernel (aligner_tpu_torch/csrc/dp_fill_core.cuh)
// for the CPU tests, on the warp emulation of tests/warp_host.h: every
// thread of a block a std::thread, the block's shared memory a vector and
// its __syncthreads a barrier.  So the kernel's own body (the columns in
// shared memory and the rows spilled past S, the 8-row pipeline, the
// direction words, the argmax tree and the score plane) runs as written,
// on the instances the library builds (dpf::with_instance), and its
// outputs are held against the plain PyTorch version.
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
