// Batched traceback walk over packed direction words (K4).
//
// Replaces: aligner_tpu/ops/device_walk.py::_walk_device (a lax.scan in
// the JAX package, packed format), the walk that follows a full-mode fill
// on the main path.
//
// The kernel is the walker core's device_walk_kernel (walk_core.cuh: what
// bounds a walk on the H100 and what the design does about it are set out
// there): one warp a problem, 8 rows a word, WALK_DEPTH word rows of each
// problem staged ahead of its cursor in the warp's part of shared memory,
// runs of one code taken a ballot at a time.  Its launch plan (warps a
// block, blocks, span) is pure arithmetic in ops/device_walk.py:plan_walk.
//
// Semantics are exactly _walk_device's: word (r >> 3) * C + c, code at
// bit 2 * (r & 7) for r = y - 1, c = x - 1 (index clipped to the plane);
// global borders synthesised as Left (y == 0) and Top (x == 0), local
// borders Beginning; 16 two-bit codes per int32 word, padded with
// Beginning, step-major (ceil(S/16), B).
//
// The counting walk (device_walk_count_launch) is the same kernel with the
// population's frequency count as its epilogue (walk_core.cuh, COUNT); it
// is the counterpart of the step unpack and frequency scatter-add of
// aligner_tpu/heuristic.py:207-242.
#include "walk_core.cuh"

namespace {

// One instance of device_walk_kernel on `blocks` blocks of `warps` warps
// with `smem` bytes of shared memory a block (allowed past 48 KB where it
// needs more).  Returns the CUDA error of the launch (0 on success).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, int warps, size_t smem, void* stream, Args... args) {
    if (smem > 48 * 1024) {
        const cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

bool plan_ok(int B, int warps, int blocks, int span) {
    return warps >= 1 && warps <= 8 && span >= 4 && (long long)blocks * warps >= B;
}

bool vec_ok(const void* words, int C, int span) {
    return C % 4 == 0 && span % 4 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
}

}  // namespace

// B walks in `blocks` blocks of `warps` warps, one warp a problem, each
// with a ring of walk::WALK_DEPTH word rows of `span` columns, copied 16
// bytes at a time where the words allow it; `stats` null or three ints the
// walks add their rows asked for, their refills and their rounds to.
// Returns the CUDA error of the launch (0 on success) or -1 for an
// unsupported plan.
extern "C" int device_walk_launch(
    const void* words, int word_rows, int C, const void* sy, const void* sx,
    int B, int S, int is_global, void* steps, void* n, void* ey, void* ex,
    int warps, int blocks, int span, void* stats, void* stream) {
    cudaGetLastError();  // clear a stale error so the check below is ours
    if (!plan_ok(B, warps, blocks, span)) return -1;
    const bool vec = vec_ok(words, C, span);
    const size_t smem = sizeof(int) * size_t(warps) * walk::walk_warp_ints(span, 0);
    auto kernel = is_global
        ? (vec ? device_walk_kernel<true, 4, false> : device_walk_kernel<true, 1, false>)
        : (vec ? device_walk_kernel<false, 4, false> : device_walk_kernel<false, 1, false>);
    return launch(kernel, blocks, warps, smem, stream, static_cast<const int*>(words),
                  word_rows, C, static_cast<const int*>(sy), static_cast<const int*>(sx), B,
                  S, span, static_cast<int*>(steps), static_cast<int*>(n),
                  static_cast<int*>(ey), static_cast<int*>(ex), static_cast<int*>(stats),
                  walk::CountArgs{});
}

// The counting walk: B local walks as device_walk_launch's, each warp then
// counting its member's (target char, query char) pairs (count_core.cuh)
// from q (B, Cq) and t (B, Rt) into counts (B, V, V), the seed pair where
// alive[b].  Returns the CUDA error of the launch, -1 for an unsupported
// plan, or -2 where a block's counts do not fit the card's shared memory.
extern "C" int device_walk_count_launch(
    const void* words, int word_rows, int C, const void* sy, const void* sx,
    int B, int S, void* steps, void* n, void* ey, void* ex, const void* q, int Cq,
    const void* t, int Rt, const void* alive, int V, void* counts,
    int warps, int blocks, int span, void* stats, void* stream) {
    cudaGetLastError();  // clear a stale error so the check below is ours
    if (!plan_ok(B, warps, blocks, span) || Cq < 1 || Rt < 1 || V < 1) return -1;
    const size_t smem = sizeof(int) * size_t(warps) * walk::walk_warp_ints(span, V);
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (smem > size_t(optin)) return -2;
    auto kernel = vec_ok(words, C, span) ? device_walk_kernel<false, 4, true>
                                         : device_walk_kernel<false, 1, true>;
    const walk::CountArgs count{static_cast<const int*>(q), Cq, static_cast<const int*>(t),
                                Rt, static_cast<const unsigned char*>(alive), V,
                                static_cast<int*>(counts)};
    return launch(kernel, blocks, warps, smem, stream, static_cast<const int*>(words),
                  word_rows, C, static_cast<const int*>(sy), static_cast<const int*>(sx), B,
                  S, span, static_cast<int*>(steps), static_cast<int*>(n),
                  static_cast<int*>(ey), static_cast<int*>(ex), static_cast<int*>(stats),
                  count);
}
