// Batched traceback walk over packed direction words.
//
// Replaces: aligner_tpu/ops/device_walk.py::_walk_device (a lax.scan in
// the JAX package, packed format), the walk that follows a full-mode fill
// on the main path.
//
// What bounds it on the H100: each walk is a serial pointer chase of at
// most S = R + C + 1 dependent steps (the next word to read depends on the
// last direction), so a thread's time is S round trips to the cache or
// device memory, and the problems are the only parallel axis.  The bytes
// moved are small: one 4-byte word per step read, 2 bits per step written.
//
// What the design does about it: one thread per problem; a thread stops
// reading as soon as its walk reaches Beginning and writes the rest of its
// stream as all-Beginning words, so short local walks cost only their own
// length; the step stream is written step-major (S/16, B) so a warp's
// stores are coalesced.
//
// Semantics are exactly _walk_device's: word (r >> 3) * C + c, code at
// bit 2 * (r & 7) for r = y - 1, c = x - 1 (index clipped to the plane);
// global borders synthesised as Left (y == 0) and Top (x == 0), local
// borders Beginning; 16 two-bit codes per int32 word, padded with
// Beginning.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TOP = 0, LEFT = 1, DIAG = 2, BEG = 3;

template <bool GLOBAL>
__global__ void device_walk_kernel(
    const int* __restrict__ words,  // (B, W) packed directions, W = R8/8 * C
    long long W, const int* __restrict__ sy, const int* __restrict__ sx,
    int B, int C, int S,
    int* __restrict__ steps,        // (ceil(S/16), B)
    int* __restrict__ n_out, int* __restrict__ ey, int* __restrict__ ex)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int* w_b = words + (long long)b * W;
    const long long Bl = B;
    const int n_words = (S + 15) / 16;
    int y = sy[b], x = sx[b], n = 0;
    bool done = false;
    int s = 0;
    for (int k = 0; k < n_words; ++k) {
        unsigned word = 0u;
        for (int j = 0; j < 16; ++j, ++s) {
            int d = BEG;
            if (!done && s < S) {
                if (GLOBAL && y == 0) {
                    d = x >= 1 ? LEFT : BEG;
                } else if (GLOBAL && x == 0) {
                    d = y >= 1 ? TOP : BEG;
                } else if (!GLOBAL && (y < 1 || x < 1)) {
                    d = BEG;
                } else {
                    const int r = y - 1;
                    long long idx = (long long)(r >> 3) * C + (x - 1);
                    idx = idx < 0 ? 0 : (idx > W - 1 ? W - 1 : idx);
                    d = (w_b[idx] >> ((r & 7) * 2)) & 3;
                }
                if (d == BEG) {
                    done = true;
                } else {
                    ++n;
                    if (d == TOP || d == DIAG) --y;
                    if (d == LEFT || d == DIAG) --x;
                }
            }
            word |= unsigned(d) << (2 * j);
        }
        steps[(long long)k * Bl + b] = int(word);
    }
    n_out[b] = n;
    ey[b] = y;
    ex[b] = x;
}

}  // namespace

extern "C" int device_walk_launch(
    const void* words, long long W, const void* sy, const void* sx,
    int B, int C, int S, int is_global,
    void* steps, void* n, void* ey, void* ex, int threads, void* stream) {
    cudaGetLastError();  // clear a stale error so the check below is ours
    const int blocks = (B + threads - 1) / threads;
    auto st = static_cast<cudaStream_t>(stream);
    auto w = static_cast<const int*>(words);
    auto y0 = static_cast<const int*>(sy);
    auto x0 = static_cast<const int*>(sx);
    auto so = static_cast<int*>(steps);
    auto no = static_cast<int*>(n);
    auto yo = static_cast<int*>(ey);
    auto xo = static_cast<int*>(ex);
    if (is_global)
        device_walk_kernel<true><<<blocks, threads, 0, st>>>(w, W, y0, x0, B, C, S, so, no, yo, xo);
    else
        device_walk_kernel<false><<<blocks, threads, 0, st>>>(w, W, y0, x0, B, C, S, so, no, yo, xo);
    return static_cast<int>(cudaGetLastError());
}
