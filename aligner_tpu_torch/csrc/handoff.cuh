// What the fills of one global pair share for handing a row from one warp
// to the next: the row goes down as 64-bit words, each value in the low half
// and, in the high half, the index of the warp's work item that may read it.
// A word is read and written whole, with relaxed loads and stores at GPU
// scope (L2, never the L1, which is not coherent across SMs), so the tag
// proves its value and no fence, flag or acquire is needed.  A wait gives up
// after WAIT_LIMIT_CYCLES and traps: a hang becomes a failed launch, never a
// result.
//
// Used by the strip walk (wavefront_tile.cuh) and the band walk
// (wavefront_band.cu).  The CUDA-only primitives (the dynamic shared memory,
// the relaxed load and store) sit under __CUDACC__; a host build of a body
// supplies its own, with the warp intrinsics it uses.
#pragma once
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr long long WAIT_LIMIT_CYCLES = 1LL << 32;  // about 2 s of SM clock

#ifdef __CUDACC__
__device__ __forceinline__ int* dynamic_smem() {
    extern __shared__ int smem[];
    return smem;
}

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p));
    return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v));
}
#endif

// A value handed down to work item `tag`.
__device__ __forceinline__ unsigned long long tagged(int v, int tag) {
    return (static_cast<unsigned long long>(static_cast<unsigned>(tag)) << 32) |
           static_cast<unsigned>(v);
}

// The value of a tagged word, and the work item it was handed to.
__device__ __forceinline__ int word_value(unsigned long long w) {
    return static_cast<int>(static_cast<unsigned>(w));
}

__device__ __forceinline__ int word_tag(unsigned long long w) {
    return static_cast<int>(w >> 32);
}

}  // namespace
