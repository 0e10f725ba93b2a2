// The walker core of the two traceback walks: the replay walk of one huge
// global pair (W, launched by wavefront.cu) and the batched walk of the main
// path (K4, launched by device_walk.cu).
//
// Replaces: aligner_tpu/ops/wavefront.py::walk_tile_inner (the
// lax.while_loop inside _replay_walk_all) and
// aligner_tpu/ops/device_walk.py::_walk_device (a lax.scan).
//
// What a walk computes: from a cursor (y, x), 1-based, it reads the 2-bit
// direction code of cell (y, x) from words packed RPW rows a word (word
// (y - 1) / RPW of column x - 1, the code at bit 2 * ((y - 1) % RPW)),
// appends it to a stream of 16 codes a 32-bit word and moves: TOP up, LEFT
// left, DIAG both.  W packs 16 rows a word and stops on its block's top or
// left edge; K4 packs 8 and ends at Beginning, its global borders walked
// as runs of LEFT and TOP.
//
// What bounds it on the H100: a walk is a serial pointer chase, one cursor
// a problem, and the word a step reads depends on the step before.  A word
// fetched from device memory when the step needs it costs a round trip
// (about 0.6-1 us), and one warp, or one warp an SM, has nothing to hide it
// behind; a step done one at a time is a dozen dependent instructions.  The
// bytes are small: one word row every RPW steps at most.
//
// What the core does about it (one warp a walk):
//   * The walk moves only up and left, so the only words it can reach next
//     are those of the word rows above the cursor, left of its column.  The
//     warp keeps D of them in a ring in shared memory, each slot a span of
//     `span` columns ending at the cursor's column when the row was asked
//     for.  As it leaves a row it asks for the row D above with cp.async,
//     so rows are under way while it walks.  A cursor that runs left of its
//     row's span refills the row synchronously (counted: `refills`).
//   * A run of one code is taken a round at a time: lane i reads the
//     cursor's word and the cells i steps along a LEFT run and a DIAG run,
//     all at once; the cursor's code picks the run and one ballot gives its
//     length, up to 32 steps.  A run of TOP codes inside a word (TOP = 0)
//     is taken from a count of leading zeros.  A DIAG run crosses up to
//     32 / RPW word rows, so the ring keeps those landed.
//   * Codes come into a register two bits at a time by funnel shifts; lane
//     0 stores a word every 16 codes.
// W runs one warp (one launch a call); K4 one warp a problem, so a batch of
// B problems keeps B walkers under way where one thread a problem kept
// B / 32 warps, about one an SM at the main path's batches.
//
// The CUDA-only primitives (cp.async, the shared-memory loads) sit under
// __CUDACC__; a host build of the kernels (tests/walk_host.cpp) supplies
// them, its copies landing at their wait.
#pragma once
#include "count_core.cuh"
#include "handoff.cuh"

namespace {

#ifdef __CUDACC__
__device__ __forceinline__ int lane_id() { return int(threadIdx.x & 31); }

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// a shared-memory address, and a load from and a store to one: the walk's
// loads go to shared memory without a generic-address conversion each, and
// its own stores to the ring are volatile too, so that none moves across
// another, a wait or a __syncwarp
using saddr_t = unsigned;
__device__ __forceinline__ saddr_t smem_addr(const int* p) {
    return static_cast<saddr_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ int lds(saddr_t a) {
    int v;
    asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(a));
    return v;
}
__device__ __forceinline__ void sts(saddr_t a, int v) {
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(v));
}
#endif

namespace walk {

constexpr int TOP = 0, LEFT = 1, DIAG = 2, BEG = 3;
// why walk_runs returned
constexpr int STOP_EDGE = 0, STOP_BEG = 1, STOP_LIMIT = 2;
// Columns of guard before each slot's words, so that its 16-byte copies
// start on whole groups.
constexpr int GUARD = 8;
// The word rows of the rings the walks are built with: W's one warp stages
// REPLAY_DEPTH, each of K4's warps WALK_DEPTH (timed on an H100 by
// ops/walk_probe.py, whose variants build other depths).
constexpr int REPLAY_DEPTH = 4;
constexpr int WALK_DEPTH = 8;

// The ints of shared memory one walker's ring takes: D slots of GUARD +
// `span` columns, then the D first columns, in whole 16-byte groups.
__host__ __device__ constexpr int ring_ints(int D, int span) {
    return D * (span + GUARD) + (D < 4 ? 4 : D);
}

// The ints of shared memory one warp of K4 takes: its ring, and for the
// counting walk (V > 0) at least the member's V * V counts, which take the
// ring's place once the walk is done; in whole 16-byte groups.
__host__ __device__ constexpr int walk_warp_ints(int span, int V) {
    const int counts = (V * V + 3) & ~3;
    return ring_ints(WALK_DEPTH, span) > counts ? ring_ints(WALK_DEPTH, span) : counts;
}

// What the counting walk counts with: the members' padded codes q (B, Cq)
// and t (B, Rt), which members are alive, V, and the (B, V, V) counts out.
struct CountArgs {
    const int* q;
    int Cq;
    const int* t;
    int Rt;
    const unsigned char* alive;
    int V;
    int* out;
};

// The stream of codes: 16 a word, stored by lane 0 at out[k * stride].
// Every lane keeps the same copy.  Codes come in at the top of `cur` and
// move down two bits a code (one funnel shift), so a word is whole after 16
// and its first code sits in bits 0-1; `left` counts the codes the word
// still takes, `room` those the stream does.
struct Stream {
    int* wp;          // the word under way
    long long stride;
    unsigned cur;     // its codes so far, in the top 2 * (16 - left) bits
    int left;         // codes to the word's end
    int room;         // codes to the stream's end
    int limit;        // the stream's length in codes

    // A stream of `limit` codes at out, `n` of them taken, the word under
    // way holding `first` (its codes before n kept)
    __device__ __forceinline__ Stream(int* out, long long stride_, int limit_, int n,
                                      unsigned first)
        : wp(out + (n >> 4) * stride_), stride(stride_),
          cur((n & 15) ? first << (32 - 2 * (n & 15)) : 0u), left(16 - (n & 15)),
          room(limit_ - n), limit(limit_) {}

    __device__ __forceinline__ int n() const { return limit - room; }

    // k more copies of the code pattern, k <= left; the word stored once
    // whole, by a predicated store and selects rather than a branch
    __device__ __forceinline__ void piece(unsigned pattern, int k) {
        cur = __funnelshift_rc(cur, pattern, 2 * k);
        left -= k;
        room -= k;
        const bool whole = left == 0;
        if (whole & (lane_id() == 0)) *wp = int(cur);
        wp = whole ? wp + stride : wp;
        left = whole ? 16 : left;
    }

    // m copies of code d, 0 <= m <= min(32, room): at most three pieces,
    // to the word's end, a whole word and the rest
    __device__ __forceinline__ void put(int d, int m) {
        const unsigned pattern = unsigned(d) * 0x55555555u;
        int k = min(m, left);
        piece(pattern, k);
        m -= k;
        k = min(m, 16);
        piece(pattern, k);
        piece(pattern, m - k);
    }

    // k copies of code d, any 0 <= k <= room
    __device__ void put_long(int d, int k) {
        while (k > 0) {
            const int m = min(k, 32);
            put(d, m);
            k -= m;
        }
    }

    // The word under way with its codes in place and `beyond` in the
    // positions past them.
    __device__ __forceinline__ unsigned partial(unsigned beyond) const {
        const int j = 16 - left;
        const unsigned low = (1u << (2 * j)) - 1u;
        return ((cur >> (32 - 2 * j)) & low) | (beyond & ~low);
    }
};

// D word rows of one warp in shared memory: row g in slot g % D, its
// columns lo[slot] .. lo[slot] + span - 1 (those left of column 0 absent).
// With VEC = 4 the copies are 16 bytes, the columns asked for rounded out
// to whole groups of four (the row stride and span multiples of 4, the
// words 16-byte aligned).
template <int RPW, int D, int VEC>
struct Ring {
    static_assert(D >= 2 && (D & (D - 1)) == 0, "D is a power of two");
    const int* words;  // word row g, column c at words[g * stride + c]
    long long stride;
    int* base;         // ring_ints(D, span) ints
    int span;
    int loads = 0, refills = 0, rounds = 0;  // rows asked for, rows refilled, rounds
    saddr_t sbase = smem_addr(base);

    __device__ __forceinline__ int* slot(int g) const {
        return base + (g & (D - 1)) * (span + GUARD) + GUARD;
    }
    // the shared-memory address of column 0 of row g's slot holding `first`
    __device__ __forceinline__ saddr_t column0(int g, int first) const {
        return sbase + saddr_t(4 * ((g & (D - 1)) * (span + GUARD) + GUARD - first));
    }
    // the first column row g's slot holds
    __device__ __forceinline__ saddr_t lo_addr(int g) const {
        return sbase + saddr_t(4 * (D * (span + GUARD) + (g & (D - 1))));
    }
    __device__ __forceinline__ int lo_of(int g) const { return lds(lo_addr(g)); }

    // the first column a slot asked for up to column hi takes
    __device__ __forceinline__ int first(int hi) const {
        return VEC == 4 ? max(((hi + 3) & ~3) - span, 0) : max(hi - span, 0);
    }

    // Ask for word row g's columns first(hi) .. hi - 1 (none for g < 0)
    // without waiting; one cp.async group a call, empty or not.
    __device__ __forceinline__ void ask(int g, int hi) {
        if (g >= 0) {
            const int l = first(hi);
            int* s = slot(g) - l;
            const int* w = words + g * stride;
            if (VEC == 4) {
                for (int c = l + 4 * lane_id(); c < hi; c += 128) cp_async16(s + c, w + c);
            } else {
                for (int c = l + lane_id(); c < hi; c += 32) cp_async4(s + c, w + c);
            }
            if (lane_id() == 0) sts(lo_addr(g), l);
            ++loads;
        }
        cp_async_commit();
    }

    // The same, synchronously, for the row the cursor is on.
    __device__ void refill(int g, int hi) {
        const int l = first(hi);
        const saddr_t a = column0(g, l);
        const int* w = words + g * stride;
        __syncwarp();
        for (int c = l + lane_id(); c < hi; c += 32) sts(a + 4 * c, w[c]);
        if (lane_id() == 0) sts(lo_addr(g), l);
        __syncwarp();
        ++refills;
    }
};

// Walk from (y, x), 1 <= y <= the rows of the words, 1 <= x <= their
// columns, until the cursor reaches row 0 or column 0 (STOP_EDGE), meets a
// Beginning code (STOP_BEG: the cursor on its cell, the code not put), or
// the stream is full (STOP_LIMIT).  Every lane of the warp calls it with
// the same arguments and ends with the same cursor and stream; no copy is
// in flight when it returns.
template <int RPW, int D, int VEC>
__device__ int walk_runs(Ring<RPW, D, VEC>& ring, int& y, int& x, Stream& st) {
    // the word rows above the cursor's a round may reach; the ring keeps
    // rows g .. g - NR landed and D - 1 - NR more under way
    constexpr int NR = 32 / RPW < D - 1 ? 32 / RPW : D - 1;
    constexpr int LOG = RPW == 16 ? 4 : 3;
    static_assert(RPW == 1 << LOG, "RPW is 8 or 16");
    const int lane = lane_id();
    int g = (y - 1) / RPW;
    for (int k = 0; k < D; ++k) ring.ask(g - k, x);
    cp_async_wait<D - 1 - NR>();
    __syncwarp();
    int c = x - 1;            // the cursor's column
    int r = y - 1 - g * RPW;  // its row inside word row g
    int lov[NR + 1];          // the first columns of rows g .. g - NR
#pragma unroll
    for (int k = 0; k <= NR; ++k) lov[k] = ring.lo_of(g - k);
    int why;
    for (;; ++ring.rounds) {
        if (c < lov[0]) {  // left of the span
            ring.refill(g, c + 1);
            lov[0] = ring.lo_of(g);
        }
        // lane i reads the cursor's word and the cells i steps along a LEFT
        // run (row g) and a DIAG run (dg word rows up), all at once
        const int ci = c - lane;
        const int t = r - lane;
        const int dg = -(t >> LOG);
        int li = lov[0];
#pragma unroll
        for (int k = 1; k <= NR; ++k) li = dg == k ? lov[k] : li;
        const bool in_l = ci >= lov[0];
        const bool in_d = dg <= NR && g >= dg && ci >= li;
        const saddr_t a_g = ring.column0(g, lov[0]);
        const unsigned w = unsigned(lds(a_g + 4 * c));
        const unsigned wl = in_l ? unsigned(lds(a_g + 4 * ci)) : 0u;
        const unsigned wd = in_d ? unsigned(lds(ring.column0(g - dg, li) + 4 * ci)) : 0u;
        const int d = int(w >> (2 * r)) & 3;
        if (d == BEG) {
            why = STOP_BEG;
            break;
        }
        if (d == TOP) {
            // TOP down to the highest row below whose code is not
            const unsigned below = w & ((4u << (2 * r)) - 1u);
            const int h = below ? (31 - __clz(int(below))) >> 1 : -1;
            const int m = min(r - h, st.room);
            st.put(TOP, m);
            r -= m;
        } else {
            const bool diag = d == DIAG;
            const unsigned wi = diag ? wd >> (2 * (t & (RPW - 1))) : wl >> (2 * r);
            const bool same = (diag ? in_d : in_l) && int(wi & 3u) == d;
            const unsigned stop = __ballot_sync(FULL, !same);
            // lane 0 is the cursor's cell, so the run has a step at least
            const int m = min(stop ? __ffs(int(stop)) - 1 : 32, st.room);
            st.put(d, m);
            c -= m;
            if (diag) r -= m;
        }
        const int gn = g + (r >> LOG);  // the cursor's word row now
        r &= RPW - 1;
        y = gn * RPW + r + 1;
        x = c + 1;
        if (st.room == 0) {
            why = STOP_LIMIT;
            break;
        }
        if (y == 0 || x == 0) {
            why = STOP_EDGE;
            break;
        }
        if (gn < g) {  // the slots of the rows left take rows D below them
            __syncwarp();
            for (int k = g; k > gn; --k) ring.ask(k - D, x);
            g = gn;
            cp_async_wait<D - 1 - NR>();
            __syncwarp();
#pragma unroll
            for (int k = 0; k <= NR; ++k) lov[k] = ring.lo_of(g - k);
        }
    }
    cp_async_wait<0>();
    __syncwarp();
    return why;
}

}  // namespace walk

// W: one cursor walks the packed words (16 rows a word) of one replayed
// block, one warp, REPLAY_DEPTH rows in its ring.  `state` holds (cy, cx, n): the
// absolute 1-based cell and the running step count; the block holds the
// rows row_base + 1 .. row_base + rows and the columns col_base + 1 ..
// col_base + C_pad, and the kernel does nothing unless the cursor lies
// inside them.  The walk leaves the block by its top or its left edge, or
// stops when the stream holds `budget` codes; a Beginning code (which a
// global interior never holds) is repeated to the budget without a move.
// `stats`, when given, gains the rows asked for, the rows refilled and the
// rounds walked.
template <int VEC>
__global__ void __launch_bounds__(32)
replay_walk_kernel(const int* __restrict__ words, long long C_pad, int row_base,
                   int col_base, int rows, int* __restrict__ state, int* __restrict__ steps,
                   int budget, int span, int* __restrict__ stats) {
    int y = state[0] - row_base;  // 1-based row within the block
    int x = state[1] - col_base;  // 1-based column within the block
    const int n = state[2];
    if (y < 1 || y > rows || x < 1 || x > C_pad) return;
    walk::Ring<16, walk::REPLAY_DEPTH, VEC> ring{words, C_pad, dynamic_smem(), span};
    // the stream's word under way keeps its codes before n, and those past
    // the walk's last if the walk ends in it
    const unsigned orig = n < budget ? unsigned(steps[n >> 4]) : ~0u;
    walk::Stream st{steps, 1, budget, n, orig};
    if (st.room > 0 && walk::walk_runs(ring, y, x, st) == walk::STOP_BEG)
        st.put_long(walk::BEG, st.room);
    if (lane_id() == 0) {
        const int m = st.n();
        if ((m & 15) != 0 && m < budget)
            *st.wp = int(st.partial((m >> 4) == (n >> 4) ? orig : ~0u));
        state[0] = row_base + y;
        state[1] = col_base + x;
        state[2] = m;
        if (stats) {
            atomicAdd(stats, ring.loads);
            atomicAdd(stats + 1, ring.refills);
            atomicAdd(stats + 2, ring.rounds);
        }
    }
}

// K4: B walks over (B, R8/8, C) words packed 8 rows a word (word
// (r >> 3) * C + c of a problem), one warp a problem with WALK_DEPTH rows in
// its ring, for at most S steps,
// into the step-major (ceil(S/16), B) stream; n, ey, ex the steps taken and
// the end cell.  Global borders are walked as LEFT (y == 0) and TOP
// (x == 0) runs, local ones are Beginning; a cursor off the plane reads the
// word at its index clipped to the plane, one step at a time, as the
// reference does.  After a walk ends its words are all Beginning.  `stats`,
// when given, gains the rows asked for, the rows refilled and the rounds
// walked.
//
// With COUNT (local mode only), the counting walk: the count of
// count_core.cuh as the walk's epilogue, on the stream its warp has just
// written, the member's (V, V) counts in the warp's shared memory where its
// ring was (walk_warp_ints(span, V) ints a warp), written to count.out: on
// the heuristic population's path one launch an iteration for the walk and
// the count, the stream read back by the warp that has just written it.
template <bool GLOBAL, int VEC, bool COUNT>
__global__ void __launch_bounds__(256)
device_walk_kernel(const int* __restrict__ words, int word_rows, int C,
                   const int* __restrict__ sy, const int* __restrict__ sx, int B, int S,
                   int span, int* __restrict__ steps, int* __restrict__ n_out,
                   int* __restrict__ ey, int* __restrict__ ex, int* __restrict__ stats,
                   walk::CountArgs count) {
    static_assert(!(COUNT && GLOBAL), "the counting walk is local");
    const int warp = int(threadIdx.x >> 5);
    const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= B) return;
    const int lane = lane_id();
    const long long W = (long long)word_rows * C;
    const int* w_b = words + b * W;
    constexpr int D = walk::WALK_DEPTH;
    int* const mine = dynamic_smem() + warp * walk::walk_warp_ints(span, COUNT ? count.V : 0);
    walk::Ring<8, D, VEC> ring{w_b, C, mine, span};
    walk::Stream st{steps + b, B, S, 0, ~0u};
    int y = sy[b], x = sx[b];
    while (st.room > 0) {
        if (GLOBAL && y == 0) {  // the top border: LEFT to (0, 0)
            if (x < 1) break;
            const int k = min(x, st.room);
            st.put_long(walk::LEFT, k);
            x -= k;
        } else if (GLOBAL && x == 0) {  // the left border: TOP to (0, 0)
            if (y < 1) break;
            const int k = min(y, st.room);
            st.put_long(walk::TOP, k);
            y -= k;
        } else if (!GLOBAL && (y < 1 || x < 1)) {
            break;
        } else if (y <= 8 * word_rows && x <= C && y >= 1 && x >= 1) {
            if (walk::walk_runs(ring, y, x, st) == walk::STOP_BEG) break;
        } else {  // off the plane: one step on the clipped index
            const int r = y - 1;
            long long idx = (long long)(r >> 3) * C + (x - 1);
            idx = idx < 0 ? 0 : (idx > W - 1 ? W - 1 : idx);
            const int d = (w_b[idx] >> ((r & 7) * 2)) & 3;
            if (d == walk::BEG) break;
            st.put(d, 1);
            if (d == walk::TOP || d == walk::DIAG) --y;
            if (d == walk::LEFT || d == walk::DIAG) --x;
        }
    }
    const int n = st.n();
    if (lane == 0 && (n & 15) != 0) *st.wp = int(st.partial(~0u));
    for (int k = (n + 15) / 16 + lane; k < (S + 15) / 16; k += 32)
        steps[(long long)k * B + b] = -1;
    if (COUNT) {
        // lane 0's words visible to every lane; the ring is idle (walk_runs
        // ends with no copy in flight), so the counts take its memory
        __syncwarp();
        const int V = count.V;
        fc::count_member(steps + b, B, (S + 15) / 16, n, sy[b], sx[b], count.q + b * count.Cq,
                         count.Cq, count.t + b * count.Rt, count.Rt, count.alive[b] != 0, V,
                         mine, count.out + b * V * V);
    }
    if (lane == 0) {
        n_out[b] = n;
        ey[b] = y;
        ex[b] = x;
        if (stats) {
            atomicAdd(stats, ring.loads);
            atomicAdd(stats + 1, ring.refills);
            atomicAdd(stats + 2, ring.rounds);
        }
    }
}

}  // namespace
