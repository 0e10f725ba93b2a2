// A host build of the band walk (aligner_tpu_torch/csrc/wavefront_band.cu)
// for the CPU tests, on the warp emulation of tests/warp_host.h: every lane
// a std::thread, the warp intrinsics emulated.  So the kernel's own body
// (its steps, the chunks read ahead, the waits between row groups and the
// tagged row handed down) runs as written, with real concurrency between
// warps, and its results are held against the plain PyTorch version.
//
//     g++ -std=c++20 -O1 -pthread -shared -fPIC -I aligner_tpu_torch/csrc \
//         -o band_walk_host.so tests/band_walk_host.cpp
#include "warp_host.h"

#include "wavefront_band.cu"

struct HostRun {
    const BandArgs& a;
    int warps, blocks;
    template <int K, int P>
    int operator()() const {
        run_grid(warps, blocks, band_smem_bytes(a.V, P, warps, 1 << a.cshift) / sizeof(int),
                 [this] { band_walk_kernel<K, P>(a); });
        return 0;
    }
};

// The arguments of wavefront_band_launch; `hand` (D,) and `sync` (1,) zeroed.
extern "C" int band_walk_host(const int* t, const int* q, const int* f, const int* c1,
                              const int* c2, const int* fd, const int* matrix, int V, int TB,
                              int D, int Cb, int ext, int K, int P, int j_end, int d_end,
                              int owned, int with_rc, unsigned long long* hand, int* sync,
                              int* rb, int* rc, int* end_out, int warps, int blocks,
                              int copies) {
    const int cs = copy_shift(copies);
    if (warps < 1 || warps > MAX_BAND_WARPS || blocks < 1 || TB % (32 * K) || cs < 0)
        return -1;
    BandArgs a;
    a.t = t; a.q = q; a.f = f; a.c1 = c1; a.c2 = c2; a.fd = fd; a.matrix = matrix;
    a.hand = hand; a.sync = sync; a.rb = rb; a.rc = rc; a.end_out = end_out;
    a.V = V; a.D = D; a.Cb = Cb; a.ext = ext; a.n_g = TB / (32 * K);
    a.j_end = j_end; a.d_end = d_end; a.owned = owned; a.with_rc = with_rc;
    a.cshift = cs;
    return with_shape(K, P, HostRun{a, warps, blocks});
}
