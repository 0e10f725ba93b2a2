// A host build of the strip walk (aligner_tpu_torch/csrc/wavefront_tile.cuh)
// for the CPU tests: every lane is a std::thread, each warp's shuffles,
// votes and __syncwarp are exchanges through a std::barrier of its 32
// lanes, the block's shared memory is a vector and its __syncthreads a
// barrier of its threads, the ticket and the tagged words of the row handed
// down are std::atomic_ref accesses with the kernel's memory orders.  So the
// kernel's own body (its lane pipeline, the ring, the chunk loads and the
// waits between strips) runs as written, with real concurrency between
// warps, and its results are held against the plain PyTorch versions.
//
//     g++ -std=c++20 -O1 -pthread -shared -fPIC -I aligner_tpu_torch/csrc \
//         -o strip_walk_host.so tests/strip_walk_host.cpp
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)

struct Dim3 {
    unsigned x = 0;
};
struct WarpCtx {
    std::barrier<> bar{32};
    int slot[32] = {};
};
struct BlockCtx {
    std::barrier<> bar;
    std::vector<int> smem;
    BlockCtx(int threads, size_t ints) : bar(threads), smem(ints) {}
};
thread_local Dim3 threadIdx, blockIdx, blockDim, gridDim;
thread_local WarpCtx* warp_ctx;
thread_local BlockCtx* block_ctx;

inline int* dynamic_smem() { return block_ctx->smem.data(); }
inline void __syncwarp(unsigned = 0xffffffffu) { warp_ctx->bar.arrive_and_wait(); }
inline void __syncthreads() { block_ctx->bar.arrive_and_wait(); }
inline int lane_id() { return int(threadIdx.x & 31); }
inline int exchange(int v, int src) {
    warp_ctx->slot[lane_id()] = v;
    __syncwarp();
    const int r = warp_ctx->slot[src];
    __syncwarp();
    return r;
}
inline int __shfl_sync(unsigned, int v, int src) { return exchange(v, src); }
inline int __shfl_up_sync(unsigned, int v, unsigned d) {
    const int l = lane_id();
    return exchange(v, l >= int(d) ? l - int(d) : l);
}
inline int __all_sync(unsigned, int pred) {
    warp_ctx->slot[lane_id()] = pred != 0;
    __syncwarp();
    int all = 1;
    for (int l = 0; l < 32; ++l) all &= warp_ctx->slot[l];
    __syncwarp();
    return all;
}
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline unsigned long long load_relaxed(const unsigned long long* p) {
    return std::atomic_ref<unsigned long long>(*const_cast<unsigned long long*>(p))
        .load(std::memory_order_relaxed);
}
inline void store_relaxed(unsigned long long* p, unsigned long long v) {
    std::atomic_ref<unsigned long long>(*p).store(v, std::memory_order_relaxed);
}
inline int __ldcg(const int* p) {
    return std::atomic_ref<int>(*const_cast<int*>(p)).load(std::memory_order_relaxed);
}
inline long long clock64() {
    return std::chrono::steady_clock::now().time_since_epoch().count();
}
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
[[noreturn]] inline void __trap() { std::abort(); }
using std::max;

#include "wavefront_tile.cuh"

template <int K, bool DIRS, bool BLOCK>
void run_grid(const TileArgs& a, int warps, int blocks) {
    std::vector<std::unique_ptr<BlockCtx>> bl;
    std::vector<std::unique_ptr<WarpCtx>> wp;
    std::vector<std::thread> th;
    const size_t ints = strip_smem_bytes(a.V, a.TR, warps) / sizeof(int);
    for (int b = 0; b < blocks; ++b) {
        bl.push_back(std::make_unique<BlockCtx>(32 * warps, ints));
        for (int w = 0; w < warps; ++w) {
            wp.push_back(std::make_unique<WarpCtx>());
            BlockCtx* bc = bl.back().get();
            WarpCtx* wc = wp.back().get();
            for (int l = 0; l < 32; ++l)
                th.emplace_back([=] {
                    threadIdx.x = unsigned(32 * w + l);
                    blockIdx.x = unsigned(b);
                    blockDim.x = unsigned(32 * warps);
                    gridDim.x = unsigned(blocks);
                    warp_ctx = wc;
                    block_ctx = bc;
                    fill_strips_kernel<K, DIRS, BLOCK>(a);
                });
        }
    }
    for (auto& t : th) t.join();
}

template <bool BLOCK>
int run(const TileArgs& a, int K, int warps, int blocks) {
    const bool d = a.words != nullptr;
    switch (K) {
        case 2: d ? run_grid<2, true, BLOCK>(a, warps, blocks)
                  : run_grid<2, false, BLOCK>(a, warps, blocks); return 0;
        case 4: d ? run_grid<4, true, BLOCK>(a, warps, blocks)
                  : run_grid<4, false, BLOCK>(a, warps, blocks); return 0;
        case 8: d ? run_grid<8, true, BLOCK>(a, warps, blocks)
                  : run_grid<8, false, BLOCK>(a, warps, blocks); return 0;
        default: return -1;
    }
}

// The arguments of wavefront_block_cs_launch (lbound, hrow and rights null
// for the row-scan fill, x0 then 0), `block` choosing the instance; `hand`
// (width,) and `sync` (1,) zeroed.
extern "C" int strip_walk_host(int block, const int* q, const int* t, const int* matrix,
                               int V, const int* top, const int* lbound, int* hrow,
                               unsigned long long* hand, int* sync, int* rights, int x0,
                               int y_offset, int C_real, int R_real, int del, int ext,
                               int K, int TR, int n_tr, int n_tc, int* end_out,
                               int* words, int* ckpts, int ckpt_every, int warps,
                               int blocks) {
    TileArgs a;
    a.q = q; a.t = t; a.matrix = matrix; a.top = top; a.lbound = lbound;
    a.hrow = hrow; a.hand = hand; a.rights = rights; a.end_out = end_out; a.words = words;
    a.ckpts = ckpts; a.sync = sync;
    a.width = (long long)n_tc * 32 * K;
    a.V = V; a.x0 = x0; a.y_offset = y_offset; a.C_real = C_real; a.R_real = R_real;
    a.del = del; a.ext = ext; a.TR = TR; a.n_tr = n_tr; a.n_tc = n_tc;
    a.ckpt_every = ckpt_every;
    return block ? run<true>(a, K, warps, blocks) : run<false>(a, K, warps, blocks);
}
