// The heuristic population's frequency count: (target char, query char)
// pairs of M alignments from their packed step streams.
//
// Replaces: the step unpack and frequency scatter-add of
// aligner_tpu/heuristic.py:207-242 (jnp inside the JAX package's fused
// population loop, next to the walk _walk_device; not Pallas).  Its plain
// version is ops/freq_count.py:count_pairs_plain.
//
// What it computes: member m's walk (ops/device_walk.py) left a stream of
// n[m] two-bit codes, 16 a word, word w at steps[w * M + m] (step-major),
// taken from the start cell (sy[m], sx[m]): TOP moves the cursor up, LEFT
// left, DIAG both.  On each DIAG step the pair at the cursor before the
// step, t[y - 1] and q[x - 1] (clipped to the codes), adds one to
// counts[m][t][q]; the seeded argmax pair t[sy - 1], q[sx - 1] adds one
// where the member is alive and sy > 0 and sx > 0.
//
// What bounds it on the H100: nothing of the card's rates.  The bytes are
// a few kilobytes a member (its words, the codes it visits, V * V counts
// out) and the work a few operations a step; a population of 64 members of
// 689 steps is microseconds of either, so the launch's own latency is its
// time.  The design keeps it one launch and short:
//   * one warp a member, its (V, V) counts in shared memory (2.3 KB at
//     V = 24), blocks of 4 warps; nothing is shared across warps;
//   * a warp scan of the cursor a round of 32 words, the DIAG pairs added by
//     shared-memory atomics, the seed pair by lane 0 (count_core.cuh).
//
// The body, count_core.cuh's fc::count_member, is shared with the counting
// walk (walk_core.cuh), which runs it on the stream its warp has just
// written; the population's path takes that kernel, and this one stays as
// the earlier build that chip_smoke.py times it against.  The CUDA-only
// part (the launch) sits under __CUDACC__; a host build of the kernel's body
// (tests/freq_count_host.cpp) supplies the warp intrinsics.
#include "count_core.cuh"

namespace {

namespace fc {
constexpr int WARPS = 4;  // warps a block: 4 * 24 * 24 * 4 B = 9.2 KB of counts at most
}

// M members in blocks of fc::WARPS warps, one warp a member; dynamic shared
// memory: V * V ints a warp.
__global__ void __launch_bounds__(32 * fc::WARPS)
freq_count_kernel(const int* __restrict__ steps, int words, const int* __restrict__ n,
                  const int* __restrict__ sy, const int* __restrict__ sx,
                  const int* __restrict__ q, int C, const int* __restrict__ t, int R,
                  const unsigned char* __restrict__ alive, int M, int V,
                  int* __restrict__ out) {
    const int warp = int(threadIdx.x >> 5);
    const long long m = (long long)blockIdx.x * fc::WARPS + warp;
    if (m >= M) return;
    fc::count_member(steps + m, M, words, n[m], sy[m], sx[m], q + m * C, C, t + m * R, R,
                     alive[m] != 0, V, dynamic_smem() + warp * V * V, out + m * V * V);
}

}  // namespace

#ifdef __CUDACC__
// M members' counts in blocks of fc::WARPS warps.  Returns the CUDA error of
// the launch (0 on success) or -1 for an unsupported plan (counts that do
// not fit in a block's 48 KB of shared memory).
extern "C" int freq_count_launch(const void* steps, int words, const void* n,
                                 const void* sy, const void* sx, const void* q, int C,
                                 const void* t, int R, const void* alive, int M, int V,
                                 void* out, void* stream) {
    cudaGetLastError();  // clear a stale error so the check below is ours
    const size_t smem = sizeof(int) * size_t(fc::WARPS) * size_t(V) * size_t(V);
    if (V < 1 || C < 1 || R < 1 || smem > 48 * 1024) return -1;
    const int blocks = (M + fc::WARPS - 1) / fc::WARPS;
    freq_count_kernel<<<blocks, 32 * fc::WARPS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(steps), words, static_cast<const int*>(n),
        static_cast<const int*>(sy), static_cast<const int*>(sx), static_cast<const int*>(q),
        C, static_cast<const int*>(t), R, static_cast<const unsigned char*>(alive), M, V,
        static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
}
#endif
