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
#include "walk_core.cuh"

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
    if (warps < 1 || warps > 8 || span < 4 || (long long)blocks * warps < B) return -1;
    const bool vec = C % 4 == 0 && span % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(words) % 16 == 0;
    const size_t smem =
        sizeof(int) * size_t(warps) * walk::ring_ints(walk::WALK_DEPTH, span);
    auto kernel = is_global ? (vec ? device_walk_kernel<true, 4> : device_walk_kernel<true, 1>)
                            : (vec ? device_walk_kernel<false, 4> : device_walk_kernel<false, 1>);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(words), word_rows, C, static_cast<const int*>(sy),
        static_cast<const int*>(sx), B, S, span, static_cast<int*>(steps),
        static_cast<int*>(n), static_cast<int*>(ey), static_cast<int*>(ex),
        static_cast<int*>(stats));
    return static_cast<int>(cudaGetLastError());
}
