// The warp emulation shared by the host builds of the fills' bodies
// (tests/strip_walk_host.cpp, tests/band_walk_host.cpp): every lane is a
// std::thread, each warp's shuffles, votes and __syncwarp are exchanges
// through a std::barrier of its 32 lanes, the block's shared memory is a
// vector and its __syncthreads a barrier of its threads, the ticket and the
// tagged words of a row handed down are std::atomic_ref accesses with the
// kernels' memory orders, and a wait's clock ticks every 16 ns.
// Include it before the kernel's source; run_grid starts a grid's threads.
#pragma once
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
// A tick every 16 ns of the steady clock: a wait's bound of 2^32 ticks is
// then about 69 s, which a test machine's stalls do not reach (every lane a
// thread, 32 of them meet at each shuffle) and a hang still does.
inline long long clock64() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch()).count() >> 4;
}
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
[[noreturn]] inline void __trap() { std::abort(); }
using std::max;

// Run body() as every lane of `blocks` blocks of `warps` warps, each block
// with `smem_ints` ints of shared memory, and wait for all of them.
template <typename Body>
void run_grid(int warps, int blocks, size_t smem_ints, Body body) {
    std::vector<std::unique_ptr<BlockCtx>> bl;
    std::vector<std::unique_ptr<WarpCtx>> wp;
    std::vector<std::thread> th;
    for (int b = 0; b < blocks; ++b) {
        bl.push_back(std::make_unique<BlockCtx>(32 * warps, smem_ints));
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
                    body();
                });
        }
    }
    for (auto& t : th) t.join();
}
