// The body of the heuristic population's frequency count, the epilogue of
// the counting walk: K4's walker core with the count after the walk
// (walk_core.cuh, device_walk_kernel<false, VEC, true>).  Its plain version
// is ops/device_walk.py:count_pairs_plain.
//
// What it computes: one member's walk left a stream of n two-bit codes, 16
// a word, word w at steps[w * stride], taken from the start cell (y, x):
// TOP moves the cursor up, LEFT left, DIAG both.  On each DIAG step the
// pair at the cursor before the step, t[y - 1] and q[x - 1] (clipped to the
// codes), adds one to counts[t][q]; the seeded argmax pair t[sy - 1],
// q[sx - 1] adds one where the member is alive and sy > 0 and sx > 0.
//
// How one warp does it: the member's (V, V) counts in V * V ints of the
// warp's shared memory; a round reads 32 consecutive words of the stream,
// one a lane; each lane unpacks its 16 codes and counts its moves up and
// left; a warp scan by __shfl_up_sync gives each lane its cursor at its
// first code (the round's start minus the moves of the lanes before it);
// each lane then replays its codes and adds its DIAG pairs with
// shared-memory atomics; the round's totals carry to the next round, and
// the rounds stop at n.  Lane 0 adds the seed pair, and the warp writes its
// counts out.
//
// A host build of a kernel that includes it supplies the warp intrinsics
// (tests/warp_host.h).
#pragma once
#include "handoff.cuh"

namespace {

namespace fc {

constexpr int TOP = 0, LEFT = 1, DIAG = 2;

__device__ __forceinline__ int clip(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// One member's counts, by every lane of one warp: `words` stream words at
// steps[w * stride], `nm` codes of them taken from (sy, sx); the member's
// padded codes qm (C of them) and tm (R); `counts` V * V ints of the warp's
// shared memory, `out` V * V ints of the output.  The stream must be
// visible to every lane of the warp.
__device__ __forceinline__ void count_member(const int* steps, long long stride, int words,
                                             int nm, int sy, int sx, const int* qm, int C,
                                             const int* tm, int R, bool alive, int V,
                                             int* counts, int* out) {
    const int lane = int(threadIdx.x & 31);
    const int VV = V * V;
    for (int i = lane; i < VV; i += 32) counts[i] = 0;
    __syncwarp();
    int y = sy, x = sx;
    for (int w0 = 0; w0 < words && 16 * w0 < nm; w0 += 32) {
        const int w = w0 + lane;
        const int k_end = w < words ? min(16, max(0, nm - 16 * w)) : 0;
        const unsigned word = k_end > 0 ? unsigned(steps[(long long)w * stride]) : 0u;
        int up = 0, lf = 0;
        for (int k = 0; k < k_end; ++k) {
            const int d = int(word >> (2 * k)) & 3;
            up += d == TOP || d == DIAG;
            lf += d == LEFT || d == DIAG;
        }
        int su = up, sl = lf;  // inclusive sums over the lanes
        for (int s = 1; s < 32; s <<= 1) {
            const int a = __shfl_up_sync(FULL, su, s);
            const int b = __shfl_up_sync(FULL, sl, s);
            if (lane >= s) {
                su += a;
                sl += b;
            }
        }
        int cy = y - (su - up), cx = x - (sl - lf);
        for (int k = 0; k < k_end; ++k) {
            const int d = int(word >> (2 * k)) & 3;
            if (d == DIAG)
                atomicAdd(&counts[tm[clip(cy - 1, R - 1)] * V + qm[clip(cx - 1, C - 1)]], 1);
            cy -= d == TOP || d == DIAG;
            cx -= d == LEFT || d == DIAG;
        }
        y -= __shfl_sync(FULL, su, 31);
        x -= __shfl_sync(FULL, sl, 31);
    }
    __syncwarp();
    if (lane == 0 && alive && sy > 0 && sx > 0)
        atomicAdd(&counts[tm[clip(sy - 1, R - 1)] * V + qm[clip(sx - 1, C - 1)]], 1);
    __syncwarp();
    for (int i = lane; i < VV; i += 32) out[i] = counts[i];
}

}  // namespace fc

}  // namespace
