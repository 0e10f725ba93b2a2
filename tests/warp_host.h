// The warp emulation shared by the host builds of the kernels' bodies
// (tests/strip_walk_host.cpp, tests/band_walk_host.cpp,
// tests/walk_host.cpp): every lane is a
// std::thread, each warp's shuffles, votes and __syncwarp are exchanges
// through a std::barrier of its 32 lanes, the block's shared memory is a
// vector and its __syncthreads a barrier of its threads, the ticket and the
// tagged words of a row handed down are std::atomic_ref accesses with the
// kernels' memory orders, a wait's clock ticks every 16 ns, and a lane's
// cp.async copies land only when its cp.async.wait_group lets their group
// complete (so a read of a slot before its wait sees the old words).
// Include it before the kernel's source; run_grid starts a grid's threads.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(n)

struct Dim3 {
    unsigned x = 0;
};
struct WarpCtx {
    std::barrier<> bar{32};
    int slot[32] = {};
    long long wide[32] = {};
};
// A block's shared memory, its `ints` followed by a guard of SMEM_GUARD
// ints that no kernel may touch: a write past a launch's shared memory,
// which the card reports as a fault, lands there and is seen after the
// block ends (intact()).
constexpr size_t SMEM_GUARD = 4096;
constexpr int SMEM_SENTINEL = 0x5ead0bad;
struct BlockCtx {
    std::barrier<> bar;
    std::vector<int> smem;
    size_t ints;
    BlockCtx(int threads, size_t n) : bar(threads), smem(n + SMEM_GUARD), ints(n) {
        std::fill(smem.begin() + n, smem.end(), SMEM_SENTINEL);
    }
    bool intact() const {
        return std::all_of(smem.begin() + ints, smem.end(),
                           [](int v) { return v == SMEM_SENTINEL; });
    }
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
// of any type of at most 8 bytes (int, float, double)
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
    static_assert(sizeof(T) <= sizeof(long long));
    long long bits = 0;
    std::memcpy(&bits, &v, sizeof(T));
    warp_ctx->wide[lane_id()] = bits;
    __syncwarp();
    bits = warp_ctx->wide[lane_id() ^ mask];
    __syncwarp();
    T r;
    std::memcpy(&r, &bits, sizeof(T));
    return r;
}
inline int __all_sync(unsigned, int pred) {
    warp_ctx->slot[lane_id()] = pred != 0;
    __syncwarp();
    int all = 1;
    for (int l = 0; l < 32; ++l) all &= warp_ctx->slot[l];
    __syncwarp();
    return all;
}
inline unsigned __ballot_sync(unsigned, int pred) {
    warp_ctx->slot[lane_id()] = pred != 0;
    __syncwarp();
    unsigned bits = 0;
    for (int l = 0; l < 32; ++l) bits |= unsigned(warp_ctx->slot[l]) << l;
    __syncwarp();
    return bits;
}
inline int __ffs(int v) { return __builtin_ffs(v); }
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
inline int __clz(int v) { return v ? __builtin_clz(unsigned(v)) : 32; }
// the low word of (hi:lo) >> (n & 31), and of (hi:lo) >> min(n, 32)
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned n) {
    return unsigned((((unsigned long long)hi << 32) | lo) >> (n & 31));
}
inline unsigned __funnelshift_rc(unsigned lo, unsigned hi, unsigned n) {
    return unsigned((((unsigned long long)hi << 32) | lo) >> (n < 32 ? n : 32));
}
using std::max;
using std::min;

// cp.async: a lane's copies wait in its groups, committed in order, and
// land when cp_async_wait<N> leaves at most N groups pending.
struct CopyGroups {
    std::vector<std::pair<int*, const int*>> open;
    std::deque<std::vector<std::pair<int*, const int*>>> pending;
};
thread_local CopyGroups copy_groups;
inline void cp_async4(int* dst, const int* src) { copy_groups.open.emplace_back(dst, src); }
inline void cp_async16(int* dst, const int* src) {
    for (int i = 0; i < 4; ++i) cp_async4(dst + i, src + i);
}
inline void cp_async_commit() {
    copy_groups.pending.push_back(std::move(copy_groups.open));
    copy_groups.open.clear();
}
// shared-memory addresses are plain addresses here
using saddr_t = uintptr_t;
inline saddr_t smem_addr(const int* p) { return reinterpret_cast<saddr_t>(p); }
inline int lds(saddr_t a) { return *reinterpret_cast<const int*>(a); }
inline void sts(saddr_t a, int v) { *reinterpret_cast<int*>(a) = v; }
template <int N>
inline void cp_async_wait() {
    while (copy_groups.pending.size() > size_t(N)) {
        for (auto [dst, src] : copy_groups.pending.front()) *dst = *src;
        copy_groups.pending.pop_front();
    }
}

// Run body() as every lane of blocks first .. first + count - 1 of a grid
// of `grid` blocks of `warps` warps, and wait for all of them; false when a
// block wrote past its shared memory.
template <typename Body>
bool run_blocks(int warps, int first, int count, int grid, size_t smem_ints, Body body) {
    std::vector<std::unique_ptr<BlockCtx>> bl;
    std::vector<std::unique_ptr<WarpCtx>> wp;
    std::vector<std::thread> th;
    for (int b = first; b < first + count; ++b) {
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
                    gridDim.x = unsigned(grid);
                    warp_ctx = wc;
                    block_ctx = bc;
                    body();
                });
        }
    }
    for (auto& t : th) t.join();
    return std::all_of(bl.begin(), bl.end(), [](const auto& c) { return c->intact(); });
}

// Run body() as every lane of `blocks` blocks of `warps` warps, each block
// with `smem_ints` ints of shared memory, and wait for all of them; `wave`
// blocks at a time when given (blocks that never wait on one another);
// false when a block wrote past its shared memory.
template <typename Body>
bool run_grid(int warps, int blocks, size_t smem_ints, Body body, int wave = 0) {
    bool ok = true;
    if (wave > 0 && wave < blocks) {
        for (int b0 = 0; b0 < blocks; b0 += wave)
            ok &= run_blocks(warps, b0, min(wave, blocks - b0), blocks, smem_ints, body);
    } else {
        ok = run_blocks(warps, 0, blocks, blocks, smem_ints, body);
    }
    return ok;
}
