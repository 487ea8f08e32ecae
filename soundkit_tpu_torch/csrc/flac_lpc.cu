// FLAC LPC reconstruction, wasted-bit shift and stereo decorrelation (K9).
//
// Replaces soundkit_tpu/ops/flac_lpc.py::flac_frame_device: there, a
// lax.scan over time carries a [rows, 32] history and every step sums
// history * coefficients over all 32 taps. Here a thread owns a channel
// row and runs
//
//     s[n] = r[n]                                          n < order
//     s[n] = r[n] + ((sum_k coef[k] * s[n-1-k]) >> shift)   otherwise
//
// What bounds it: bytes (each valid lane's residuals in, the whole
// [L, 2, T] output written once, mostly zeros on a ragged batch) against
// the serial chain of a row: a sample cannot start before the one
// before it is done. The design keeps that chain short and everything
// else off it.
//
// - A block takes LANES lanes. A ballot finds the valid ones (valid and
//   a block size above 0); their channel rows are packed densely onto
//   the block's ROWS compute threads, both channels of a lane side by
//   side. MOVERS more threads (whole warps) do all the memory work.
// - History and coefficients live in registers: the sample loop is
//   unrolled by the ring's depth R, so every ring slot is a compile-time
//   index. R is a bucket (4, 8 or 16) of the largest tap count in the
//   warp, the taps of a row being those up to its last non-zero
//   coefficient; taps past it are zero and add nothing, but they are
//   issued: the compute warps' issue shows in the kernel's time, so a
//   single ring of 16, or the 64-bit path alone, is slower on FLAC's
//   order-4 and order-8 rows (PERF.md §6). A warp with a
//   row of more than 16 taps (no fixture, and FLAC encoders seldom go
//   past order 12) runs the 64-bit path below from its first sample: a
//   ring of 32 in registers would not leave room for the rest.
// - While the history fits int32, the ring holds int32 and a tap is one
//   IMAD.WIDE, int32 x int32 into the 64-bit sum. The taps before s[n-1]
//   go into two partial sums, and the tap of s[n-1] enters last, so the
//   rest of the sum is ready before s[n-1] is. The products are exact
//   and sums wrap mod 2^64 in any order, so this gives the reference's
//   int64 bits. Inside the row a group of R samples is straight-line
//   code, so the scheduler overlaps the samples' older taps.
// - A row whose sample leaves int32 goes on in wrapping 64-bit
//   arithmetic, reading its history back from the sample tiles in shared
//   memory (every sample is kept there as int64): a group in which a
//   sample leaves int32 is done again that way from its start; at a
//   row's edges (its order, its last samples) a group goes sample by
//   sample and hands over on the sample after the one that left int32.
// - Tiles of TILE samples, two of each kind in shared memory. While the
//   compute threads run tile i, the movers stage tile i + 1's residuals
//   by cp.async (16 bytes where the rows allow) and write tile i - 1 of
//   every row of the block's lanes, coalesced, 16 bytes a store: the
//   wasted-bit shift and the decorrelation (left/side 8, right/side 9,
//   mid/side 10) in 64 bits at that write, cut to int32 at the store.
//   Samples past a lane's block size and invalid lanes are written as
//   zero, tiles past the block's last sample without any compute. No
//   global memory access inside the sample loop.
//
// Out-of-range amounts as XLA's int64 shifts take them, read as
// unsigned: a shift of 64 or more leaves the prediction's sign (the
// same as >> 63), wasted bits of 64 or more leave 0.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "tile_rows.cuh"

namespace {

constexpr int LANES = 32;          // lanes a block (at most 32: one warp packs them)
constexpr int ROWS = 2 * LANES;    // channel rows a block, one thread each
constexpr int TILE = 64;           // samples a tile
constexpr int MOVERS = 128;        // threads that stage tiles and write them back
constexpr int THREADS = ROWS + MOVERS;
constexpr int MAX_ORDER = 32;
constexpr int RS = TILE + 4;       // residual tile row stride (words): 16-byte rows
constexpr int SS = TILE + 1;       // sample tile row stride (int64): odd, no bank conflict
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr size_t SMEM = 2 * (sizeof(long long) * ROWS * SS + sizeof(int32_t) * ROWS * RS);

static_assert(LANES <= 32 && TILE % MAX_ORDER == 0 && ROWS % 32 == 0 && MOVERS % (TILE / 4) == 0,
              "a warp packs the lanes; rings divide tiles; movers cover a row's groups");

typedef unsigned long long u64;
typedef long long i64;

// One row's state across tiles.
struct Row {
    int32_t h[MAX_ORDER];   // the last R samples while they fit int32, slot n % R
    int32_t cf[MAX_ORDER];  // coefficients
    int ord, sh, n_live;    // order, shift (min(shift, 63) as unsigned), samples to compute
    bool wide;              // a sample has left int32: the 64-bit path from here on
};

// One sample at ring slot J of a group of R on the int32 path: false
// when it leaves int32 (it is exact all the same: its history fit). The
// taps before s[n-1] go into two partial sums (on samples already
// known), then the tap of s[n-1] enters last.
template <int R, int J>
__device__ __forceinline__ bool step(Row& w, int32_t r, bool warm, i64* out) {
    u64 part[2] = {0, 0};
#pragma unroll
    for (int k = R - 1; k >= 0; --k) {
        const u64 p = (u64)((i64)w.cf[k] * (i64)w.h[(J - 1 - k) & (R - 1)]);  // one IMAD.WIDE
        if (k == 0)
            part[0] += part[1] + p;
        else
            part[k & 1] += p;
    }
    const i64 s = warm ? (i64)r : (i64)((u64)(i64)r + (u64)((i64)part[0] >> w.sh));
    w.h[J] = (int32_t)s;
    *out = s;
    return s == (i64)(int32_t)s;
}

// Sample j of the tile at n0 on the 64-bit path, in wrapping arithmetic:
// its history is read back from the sample tiles, this tile's row ``st``
// and the last one's ``prev`` (which the movers only read while this
// tile runs).
template <int R>
__device__ __forceinline__ void step_wide(const Row& w, int32_t r, bool warm, i64* st,
                                          const i64* prev, int n0, int j) {
    u64 acc = 0;
#pragma unroll
    for (int k = R - 1; k >= 0; --k) {
        const int m = j - 1 - k;  // sample n - 1 - k, from the tile's start
        const i64 hv = m >= 0 ? st[m] : n0 + m >= 0 ? prev[TILE + m] : 0;
        acc += (u64)(i64)w.cf[k] * (u64)hv;
    }
    st[j] = warm ? (i64)r : (i64)((u64)(i64)r + (u64)((i64)acc >> w.sh));
}

// A group inside the row and past its order: straight-line code, no
// branch between samples. A group in which a sample leaves int32 is
// done again on the 64-bit path.
template <int R, int... J>
__device__ __forceinline__ void inner(Row& w, const int32_t* rt, i64* st, const i64* prev,
                                      int n0, int b, std::integer_sequence<int, J...>) {
    bool ok = true;
    ((ok &= step<R, J>(w, rt[b + J], false, st + b + J)), ...);
    if (ok) return;
    w.wide = true;
    for (int j = b; j < b + R; ++j) step_wide<R>(w, rt[j], false, st, prev, n0, j);
}

// Sample n0 + b + J, if it lies in [n0, hi): on the int32 path until a
// sample leaves int32, then on the 64-bit path.
template <int R, int J>
__device__ __forceinline__ void at(Row& w, const int32_t* rt, i64* st, const i64* prev, int n0,
                                   int b, int hi) {
    const int j = b + J, n = n0 + j;
    if (n >= hi) return;
    if (w.wide)
        step_wide<R>(w, rt[j], n < w.ord, st, prev, n0, j);
    else if (!step<R, J>(w, rt[j], n < w.ord, st + j))
        w.wide = true;
}

// A group at the row's edges (its order, its end), sample by sample.
template <int R, int... J>
__device__ __forceinline__ void edge(Row& w, const int32_t* rt, i64* st, const i64* prev, int n0,
                                     int b, int hi, std::integer_sequence<int, J...>) {
    (at<R, J>(w, rt, st, prev, n0, b, hi), ...);
}

// Samples [n0, hi) of the tile that starts at n0: its residuals rt, its
// samples st (the last tile's: prev), ring depth R.
template <int R>
__device__ __forceinline__ void run_tile(Row& w, const int32_t* rt, i64* st, const i64* prev,
                                         int n0, int hi) {
    constexpr auto seq = std::make_integer_sequence<int, R>();
    for (int b = 0; n0 + b < hi; b += R) {
        if (R > 16 || w.wide) {
            for (int j = b; j < hi - n0; ++j)
                step_wide<R>(w, rt[j], n0 + j < w.ord, st, prev, n0, j);
            return;
        }
        if constexpr (R <= 16) {
            if (n0 + b + R <= hi && n0 + b >= w.ord)
                inner<R>(w, rt, st, prev, n0, b, seq);
            else
                edge<R>(w, rt, st, prev, n0, b, hi, seq);
        }
    }
}

// the output of channel c of a lane from both channels' samples
__device__ __forceinline__ int32_t decorrelate(int a, int c, i64 s0, i64 s1, int ws0, int ws1) {
    const u64 c0 = (unsigned)ws0 < 64u ? (u64)s0 << ws0 : 0;
    const u64 c1 = (unsigned)ws1 < 64u ? (u64)s1 << ws1 : 0;
    u64 v = c ? c1 : c0;
    if (a == 10) {
        const u64 mid = (c0 << 1) | (c1 & 1);
        v = (u64)((i64)(c ? mid - c1 : mid + c1) >> 1);
    } else if (a == 9 && c == 0) {
        v = c1 + c0;
    } else if (a == 8 && c == 1) {
        v = c0 - c1;
    }
    return (int32_t)v;
}

// output sample j of row r of the block from the tile at n0: zero past
// the lane's block size and on lanes not packed
__device__ __forceinline__ int32_t sample_out(const i64* stile, const int* s_pack,
                                              const int* s_live, const int* s_assign,
                                              const int* s_ws, int r, int n0, int j) {
    const int p = s_pack[r >> 1];
    if (p < 0 || n0 + j >= s_live[p]) return 0;
    const i64* s0 = stile + 2 * p * SS + j;
    return decorrelate(s_assign[p], r & 1, s0[0], s0[SS], s_ws[2 * p], s_ws[2 * p + 1]);
}

__global__ void __launch_bounds__(THREADS, 2) flac_lpc_kernel(
    const int32_t* __restrict__ resw, const int32_t* __restrict__ coef,
    const int32_t* __restrict__ order, const int32_t* __restrict__ shift,
    const int32_t* __restrict__ wasted, const int32_t* __restrict__ assign,
    const int32_t* __restrict__ block_size, const bool* __restrict__ valid,
    int32_t* __restrict__ out, int L, int T) {
    extern __shared__ __align__(16) unsigned char smem[];
    i64* stile = reinterpret_cast<i64*>(smem);                           // [2][ROWS][SS]
    int32_t* rtile = reinterpret_cast<int32_t*>(stile + 2 * ROWS * SS);  // [2][ROWS][RS]
    __shared__ int s_pack[LANES];   // packed position of a local lane, -1 if not valid
    __shared__ int s_lane[LANES];   // local lane of a packed position
    __shared__ int s_live[LANES], s_assign[LANES], s_ws[ROWS];
    __shared__ int s_nv, s_nmax;

    const int t = threadIdx.x;
    const long lane0 = (long)blockIdx.x * LANES;
    if (t < 32) {  // one warp packs the block's lanes
        const long lane = lane0 + t;
        const int n_live =
            t < LANES && lane < L && valid[lane] ? min(max(block_size[lane], 0), T) : 0;
        const unsigned live = __ballot_sync(FULL, n_live > 0);
        const int p = __popc(live & ((1u << t) - 1));
        if (t < LANES) s_pack[t] = n_live > 0 ? p : -1;
        if (n_live > 0) {
            s_lane[p] = t;
            s_live[p] = n_live;
            s_assign[p] = assign[lane];
            s_ws[2 * p] = wasted[2 * lane];
            s_ws[2 * p + 1] = wasted[2 * lane + 1];
        }
        const int nmax = __reduce_max_sync(FULL, n_live);
        if (t == 0) s_nv = __popc(live), s_nmax = nmax;
    }
    __syncthreads();
    const int nv = s_nv, nmax = s_nmax;
    const int n_tiles = (T + TILE - 1) / TILE;
    const int c_tiles = (nmax + TILE - 1) / TILE;  // tiles with samples to compute

    if (t < ROWS) {
        // a compute thread: the packed row t, if there is one
        Row w;
        const bool computes = t < 2 * nv;
        const long row = computes ? 2 * (lane0 + s_lane[t >> 1]) + (t & 1) : 0;
        int taps = 0;
#pragma unroll
        for (int k = 0; k < MAX_ORDER; ++k) {
            w.cf[k] = computes ? coef[row * MAX_ORDER + k] : 0;
            w.h[k] = 0;
            if (w.cf[k] != 0) taps = k + 1;
        }
        w.ord = computes ? order[row] : 0;
        w.sh = computes ? (int)min((unsigned)shift[row], 63u) : 0;
        w.n_live = computes ? s_live[t >> 1] : 0;
        const int wtaps = __reduce_max_sync(FULL, taps);
        const int R = wtaps <= 4 ? 4 : wtaps <= 8 ? 8 : 16;
        w.wide = wtaps > 16;  // rings past 16 would not fit the registers
        __syncthreads();  // tile 0 staged
        for (int i = 0; i <= c_tiles; ++i) {
            const int n0 = i * TILE;
            if (i < c_tiles && n0 < w.n_live) {
                const int32_t* rt = rtile + ((i & 1) * ROWS + t) * RS;
                i64* st = stile + ((i & 1) * ROWS + t) * SS;
                const i64* prev = stile + ((~i & 1) * ROWS + t) * SS;
                const int hi = min(w.n_live, n0 + TILE);
                if (R == 4)
                    run_tile<4>(w, rt, st, prev, n0, hi);
                else if (R == 8)
                    run_tile<8>(w, rt, st, prev, n0, hi);
                else if (!w.wide)
                    run_tile<16>(w, rt, st, prev, n0, hi);
                else
                    run_tile<MAX_ORDER>(w, rt, st, prev, n0, hi);
            }
            __syncthreads();  // tile i computed; tile i + 1 staged
        }
        return;
    }

    // a mover: stages tile i + 1 and writes tile i - 1 while tile i is computed
    const int m = t - ROWS;
    const bool vec_in = ((T & 3) | ((uintptr_t)resw & 15)) == 0;
    const bool vec_out = ((T & 3) | ((uintptr_t)out & 15)) == 0;
    const int n_rows = 2 * nv;
    auto load = [&](int i) {
        const int n0 = i * TILE;
        const int len = min(TILE, nmax - n0);
        int32_t* dst = rtile + (i & 1) * ROWS * RS;
        if (vec_in) {
            const int q = (len + 3) >> 2;  // whole 16-byte groups; T % 4 == 0 keeps them in the row
            for (int e = m; e < n_rows * q; e += MOVERS) {
                const int pr = e / q, g = e - pr * q;
                const long row = 2 * (lane0 + s_lane[pr >> 1]) + (pr & 1);
                cp_async16(dst + pr * RS + 4 * g, resw + row * T + n0 + 4 * g);
            }
        } else {
            for (int e = m; e < n_rows * len; e += MOVERS) {
                const int pr = e / len, g = e - pr * len;
                const long row = 2 * (lane0 + s_lane[pr >> 1]) + (pr & 1);
                dst[pr * RS + g] = resw[row * T + n0 + g];
            }
        }
    };
    // the rows this mover writes with 16-byte stores, a group of G each:
    // their packed position, -1 for zeros, -2 past the last lane
    constexpr int G = TILE / 4, RPM = ROWS * G / MOVERS;
    const int g = m % G;
    int rp[RPM];
#pragma unroll
    for (int j = 0; j < RPM; ++j) {
        const int r = m / G + j * (MOVERS / G);
        rp[j] = lane0 + (r >> 1) < L ? s_pack[r >> 1] : -2;
    }
    // tile i of every row of the block's lanes; past the computed tiles, zeros
    auto write = [&](int i) {
        const int n0 = i * TILE;
        const int len = min(TILE, T - n0);
        const i64* st = stile + (i & 1) * ROWS * SS;
        const bool zeros = i >= c_tiles;
        if (vec_out && len == TILE) {
#pragma unroll
            for (int j = 0; j < RPM; ++j) {
                const int r = m / G + j * (MOVERS / G);
                if (rp[j] == -2) continue;
                int32_t v[4] = {0, 0, 0, 0};
                const int p = rp[j];
                if (!zeros && p >= 0) {
                    const int live = s_live[p] - n0 - 4 * g, a = s_assign[p];
                    const int ws0 = s_ws[2 * p], ws1 = s_ws[2 * p + 1];
                    const i64* s0 = st + 2 * p * SS + 4 * g;
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        if (u < live) v[u] = decorrelate(a, r & 1, s0[u], s0[SS + u], ws0, ws1);
                }
                *reinterpret_cast<int4*>(out + (2 * (lane0 + (r >> 1)) + (r & 1)) * (long)T + n0 +
                                         4 * g) = make_int4(v[0], v[1], v[2], v[3]);
            }
        } else {
            for (int e = m; e < ROWS * len; e += MOVERS) {
                const int r = e / len, j = e - r * len;
                const long lane = lane0 + (r >> 1);
                if (lane >= L) break;
                out[(2 * lane + (r & 1)) * (long)T + n0 + j] =
                    zeros ? 0 : sample_out(st, s_pack, s_live, s_assign, s_ws, r, n0, j);
            }
        }
    };
    if (c_tiles > 0) load(0);
    cp_async_wait();
    __syncthreads();  // tile 0 staged
    for (int i = 0; i <= c_tiles; ++i) {
        if (i + 1 < c_tiles) load(i + 1);
        if (i >= 1) write(i - 1);
        cp_async_wait();
        __syncthreads();
    }
    for (int i = c_tiles; i < n_tiles; ++i) write(i);
}

}  // namespace

extern "C" int skt_flac_lpc(const int32_t* resw, const int32_t* coef, const int32_t* order,
                            const int32_t* shift, const int32_t* wasted, const int32_t* assign,
                            const int32_t* block_size, const bool* valid, int32_t* out, int L,
                            int T, void* stream) {
    if ((long)L * T == 0) return 0;
    cudaError_t rc = cudaFuncSetAttribute(flac_lpc_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (rc != cudaSuccess) return (int)rc;
    const unsigned blocks = (unsigned)((L + LANES - 1) / LANES);
    flac_lpc_kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
        resw, coef, order, shift, wasted, assign, block_size, valid, out, L, T);
    return (int)cudaGetLastError();
}
