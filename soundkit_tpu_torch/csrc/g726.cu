// G.726 ADPCM predictor scan, decode and encode, for 16/24/32/40 kbit/s.
//
// Replaces soundkit_tpu/ops/adpcm.py::g726_decode_scan and
// ::g726_encode_scan (K6): a lax.scan over N codes in which every step
// advances each lane's two-pole/six-zero predictor (float-format
// multiply, step-size adaptation, reconstruction, state update). A
// masked step (valid == 0) freezes the lane's state and writes 0.
//
// The state of a lane is one row of 24 int32 in the fields of the JAX
// package's G726State, in order: yl yu dms dml ap a[2] b[6] pk[2] dq[6]
// sr[2] td (soundkit_tpu_torch/ops/adpcm.py::G726_LAYOUT).
//
// Exactness: the JAX step is integer arithmetic that XLA wraps on
// overflow and shifts with XLA's rule for out-of-range amounts (a left
// shift by n outside [0, 32) gives 0, an arithmetic right shift gives
// the sign). shl()/sar() (xla_int.cuh) implement that rule, so no shift is
// undefined in C++ even where the JAX code shifts in a branch that it
// then discards (_reconstruct's 14 - dex, _fmult's traced amounts), and
// the products of state values wrap through uint32 as XLA's do.
//
// What bounds it: the per-step dependency chain. Each code depends on
// the state that the previous code left, so a lane is N dependent steps;
// the bytes (one code in, one sample out) are small. The chain of a step
// runs through one fmult (the pole taps read sr and a, which the step
// before computed last), the predictor's sum, the reconstruction, the
// pole update and the history shift. The first design (one thread per
// lane, 32-thread blocks, the code/mask/output read and written in place
// with a warp's accesses strided by N, the per-rate tables in __constant__
// memory indexed by each lane's own code) took 0.9-1.35 us a step. This
// one:
//
// - stages a block's [lanes x TILE] codes (or samples) and mask bytes into
//   shared memory, and its outputs back, with coalesced accesses (cp.async
//   in 4-byte pieces where rows are 4-byte aligned, bytes otherwise), so
//   no global access is on the chain;
// - puts each rate's dqln / wi / fi in one packed shared-memory word per
//   code; for decode the lookup depends only on the code, so it is off the
//   chain;
// - spreads a lane over a group of G = 8 threads, one predictor tap
//   each: threads 0-5 hold b[k] and dq[k], threads 6-7 sr[k - 6] (a[] is
//   replicated), each computes one fmult, the group sums them with
//   __shfl_xor_sync (sez from the six zero taps, se from all eight;
//   wrapping int32 sums, so every order gives the same bits), every
//   thread computes the scalar state (yl yu dms dml ap a pk td)
//   redundantly, each b[k] updates on its own thread, and the history
//   moves one tap up with __shfl_up_sync. On an H100 one thread a lane
//   (all eight taps) and four (two taps each) were slower.
//
// A tile is staged, then stepped: its 256 steps take far longer than its
// load, so the tiles are not double-buffered. A block is one warp: four
// lanes.

#include <cuda_runtime.h>

#include <cstdint>

#include "tile_rows.cuh"
#include "xla_int.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int G = 8;                // threads a lane, one predictor tap each
constexpr int LANES = THREADS / G;  // lanes a block
constexpr int TILE = 256;  // steps staged per tile
constexpr int WIDTH = 24;

// per-rate tables, row = bits - 2 (soundkit_tpu/ops/adpcm.py::_G726_TABLES)
__constant__ int kQ[4][15] = {
    {261},
    {8, 218, 331},
    {-124, 80, 178, 246, 300, 349, 400},
    {-122, -16, 68, 139, 198, 250, 298, 339, 378, 413, 445, 475, 502, 528, 553},
};
__constant__ int kDqln[4][32] = {
    {116, 365, 365, 116},
    {-2048, 135, 273, 373, 373, 273, 135, -2048},
    {-2048, 4, 135, 213, 273, 323, 373, 425, 425, 373, 323, 273, 213, 135, 4, -2048},
    {-2048, -66, 28, 104, 169, 224, 274, 318, 358, 395, 429, 459, 488, 514, 539, 566,
     566, 539, 514, 488, 459, 429, 395, 358, 318, 274, 224, 169, 104, 28, -66, -2048},
};
__constant__ int kWi[4][32] = {
    {-22, 439, 439, -22},
    {-4, 30, 137, 582, 582, 137, 30, -4},
    {-12, 18, 41, 64, 112, 198, 355, 1122, 1122, 355, 198, 112, 64, 41, 18, -12},
    {14, 14, 24, 39, 40, 41, 58, 100, 141, 179, 219, 280, 358, 440, 529, 696,
     696, 529, 440, 358, 280, 219, 179, 141, 100, 58, 41, 40, 39, 24, 14, 14},
};
__constant__ int kFi[4][32] = {
    {0, 0xE00, 0xE00, 0},
    {0, 0x200, 0x400, 0xE00, 0xE00, 0x400, 0x200, 0},
    {0, 0, 0, 0x200, 0x200, 0x200, 0x600, 0xE00, 0xE00, 0x600, 0x200, 0x200, 0x200, 0, 0, 0},
    {0, 0, 0, 0, 0, 0x200, 0x200, 0x200, 0x200, 0x200, 0x400, 0x600, 0x800, 0xA00, 0xC00, 0xC00,
     0xC00, 0xC00, 0xA00, 0x800, 0x600, 0x400, 0x200, 0x200, 0x200, 0x200, 0x200, 0, 0, 0, 0, 0},
};

// A code's table row in one word: dqln + 2048 (12 bits), wi + 32 (11
// bits), fi >> 9 (3 bits).
__device__ __forceinline__ int pack_code(int r, int i) {
    return (kDqln[r][i] + 2048) | ((kWi[r][i] + 32) << 12) | ((kFi[r][i] >> 9) << 23);
}

// count of 2^i <= v over i in 0..14 (__clz(0) is 32)
__device__ __forceinline__ int quan_p2(int v) { return min(32 - __clz(max(v, 0)), 15); }

// The state a thread holds: the scalars (replicated over a lane's group)
// and its tap g of the eight: g < 6 a zero tap (b[g], dq[g]), g = 6, 7 a
// pole tap (a[g - 6] is a0 / a1, the history sr[g - 6]; b unused, kept 0).
struct State {
    int yl, yu, dms, dml, ap, a0, a1, pk0, pk1, td;
    int b, h;
};

__device__ __forceinline__ void load_state(const int32_t* p, int g, State& s) {
    s.yl = p[0]; s.yu = p[1]; s.dms = p[2]; s.dml = p[3]; s.ap = p[4];
    s.a0 = p[5]; s.a1 = p[6]; s.pk0 = p[13]; s.pk1 = p[14]; s.td = p[23];
    s.b = g < 6 ? p[7 + g] : 0;
    s.h = g < 6 ? p[15 + g] : p[21 + g - 6];
}

__device__ __forceinline__ void store_state(int32_t* p, int g, const State& s) {
    if (g == 0) {
        p[0] = s.yl; p[1] = s.yu; p[2] = s.dms; p[3] = s.dml; p[4] = s.ap;
        p[5] = s.a0; p[6] = s.a1; p[13] = s.pk0; p[14] = s.pk1; p[23] = s.td;
    }
    if (g < 6) {
        p[7 + g] = s.b;
        p[15 + g] = s.h;
    } else {
        p[21 + g - 6] = s.h;
    }
}

// The step's helpers compute every branch of the JAX code and select, so
// that the lanes of a warp never diverge: a divergent branch costs far
// more than the few instructions of its other side.

// s = on ? next : s, field by field with selects
__device__ __forceinline__ void keep(bool on, const State& next, State& s) {
    s.yl = on ? next.yl : s.yl;
    s.yu = on ? next.yu : s.yu;
    s.dms = on ? next.dms : s.dms;
    s.dml = on ? next.dml : s.dml;
    s.ap = on ? next.ap : s.ap;
    s.a0 = on ? next.a0 : s.a0;
    s.a1 = on ? next.a1 : s.a1;
    s.pk0 = on ? next.pk0 : s.pk0;
    s.pk1 = on ? next.pk1 : s.pk1;
    s.td = on ? next.td : s.td;
    s.b = on ? next.b : s.b;
    s.h = on ? next.h : s.h;
}

// float-format multiply; anexp is in [-6, 8], so both shifts are in range
__device__ __forceinline__ int fmult(int an, int srn) {
    const int anmag = an > 0 ? an : (wneg(an) & 0x1FFF);
    const int anexp = quan_p2(anmag) - 6;
    const int scaled = anexp >= 0 ? anmag >> max(anexp, 0) : anmag << max(-anexp, 0);
    const int anmant = anmag == 0 ? 32 : scaled;
    const int wanexp = anexp + ((srn >> 6) & 0x0F) - 13;
    const int wanmant = (wmul(anmant, srn & 0x3F) + 0x30) >> 4;
    const int up = shl(wanmant, wanexp) & 0x7FFF;
    const int down = sar(wanmant, -wanexp);
    const int retval = wanexp >= 0 ? up : down;
    return (an ^ srn) < 0 ? -retval : retval;
}

__device__ __forceinline__ int step_size(const State& s) {
    const int y = s.yl >> 6;
    const int dif = s.yu - y;
    // dif > 0: y + (dif * al >> 6); dif < 0: the same, rounded up; dif == 0: y
    const int mixed = y + ((wmul(dif, s.ap >> 2) + (dif < 0 ? 0x3F : 0)) >> 6);
    return s.ap >= 256 ? s.yu : mixed;
}

__device__ __forceinline__ int reconstruct(bool sign, int dqln, int y) {
    const int dql = dqln + (y >> 2);
    const int dex = (dql >> 7) & 15;
    const int dq_pos = sar((128 + (dql & 127)) << 7, 14 - dex);
    const int pos = sign ? dq_pos - 0x8000 : dq_pos;
    const int neg = sign ? -0x8000 : 0;
    return dql < 0 ? neg : pos;
}

__device__ __forceinline__ int float_format(int v) {
    const int e = quan_p2(v);
    return (e << 6) + sar(shl(v, 6), e);
}

// how many of the first n entries of an ascending table t are <= v: a
// sum of the compares in a tree
template <int N>
__device__ __forceinline__ int count_le(const int* t, int v) {
    if constexpr (N == 1) {
        return v >= t[0];
    } else {
        return count_le<N / 2>(t, v) + count_le<N - N / 2>(t + N / 2, v);
    }
}

template <int DECAY>
__device__ __forceinline__ void update(State& s, int g, int y, int wi, int fi, int dq, int sr,
                                       int dqsez) {
    const int pk0 = dqsez < 0;
    const int mag = dq & 0x7FFF;

    const int ylint = s.yl >> 15;
    const int ylfrac = (s.yl >> 10) & 0x1F;
    const int thr2 = ylint > 9 ? 31 << 10 : shl(32 + ylfrac, ylint);
    const int dqthr = (thr2 + (thr2 >> 1)) >> 1;
    const bool tr = s.td != 0 && mag > dqthr;

    const int yu = clampi(y + ((wi - y) >> 5), 544, 5120);
    const int yl = s.yl + yu + (wneg(s.yl) >> 6);

    // pole/zero adaptation (the tr == 0 branch), then zeroed where tr
    const int pks1 = pk0 ^ s.pk0;
    const int a2p = s.a1 - (s.a1 >> 7);
    const int fa1 = pks1 != 0 ? s.a0 : wneg(s.a0);
    const int a2p_adj = fa1 < -8191 ? a2p - 0x100 : (fa1 > 8191 ? a2p + 0xFF : a2p + (fa1 >> 5));
    const int a2p_flip = a2p_adj <= -12160 ? -12288 : (a2p_adj >= 12416 ? 12288 : a2p_adj - 0x80);
    const int a2p_same = a2p_adj <= -12416 ? -12288 : (a2p_adj >= 12160 ? 12288 : a2p_adj + 0x80);
    const int a2p_cl = (pk0 ^ s.pk1) != 0 ? a2p_flip : a2p_same;
    const int a2p_new = dqsez != 0 ? a2p_cl : a2p;

    const int a1_decayed = s.a0 - (s.a0 >> 8);
    const int a1_moved = pks1 == 0 ? a1_decayed + 192 : a1_decayed - 192;
    const int a1ul = 15360 - a2p_new;
    const int a1 = clampi(dqsez != 0 ? a1_moved : a1_decayed, -a1ul, a1ul);

    // the zero tap this thread holds (before the history moves)
    const int bd = s.b - (s.b >> DECAY);
    const int moved = (dq ^ s.h) >= 0 ? bd + 128 : bd - 128;
    s.b = tr || g >= 6 ? 0 : (mag != 0 ? moved : bd);
    const int a2p_eff = tr ? 0 : a2p_new;

    // the history's new entries (float format): dq into tap 0, sr into tap 6
    const int e = quan_p2(mag);
    const int val = (e << 6) + sar(shl(mag, 6), e);
    const int dq0 = mag == 0 ? (dq >= 0 ? 0x20 : -0x3E0) : (dq >= 0 ? val : val - 0x400);
    const int sr_ff = float_format(sr < 0 ? wneg(sr) : sr);
    const int sr0 = sr == 0 ? 0x20 : (sr > 0 ? sr_ff : (sr > -32768 ? sr_ff - 0x400 : -0x3E0));
    // every tap moves up one: dq[k] <- dq[k - 1], sr[1] <- sr[0]
    const int from_prev = __shfl_up_sync(0xFFFFFFFFu, s.h, 1, G);
    s.h = g == 0 ? dq0 : (g == 6 ? sr0 : from_prev);

    const int td = tr ? 0 : (a2p_eff < -11776);
    const int dms = s.dms + ((fi - s.dms) >> 5);
    const int dml = s.dml + (((fi << 2) - s.dml) >> 7);
    const int ap_up = s.ap + ((0x200 - s.ap) >> 4);
    const int ap_down = s.ap + (wneg(s.ap) >> 4);
    const int dd = shl(dms, 2) - dml;
    const bool fast = y < 1536 || td != 0 || (dd < 0 ? wneg(dd) : dd) >= (dml >> 3);

    s.yl = yl;
    s.yu = yu;
    s.dms = dms;
    s.dml = dml;
    s.ap = tr ? 256 : (fast ? ap_up : ap_down);
    s.a0 = tr ? 0 : a1;
    s.a1 = a2p_eff;
    s.pk1 = s.pk0;
    s.pk0 = pk0;
    s.td = td;
}

// One code: x is the code (decode) or the sample (encode); tab holds the
// rate's packed code rows. Returns the sample (decode) or the code
// (encode). Every thread of the warp calls it (the shuffles take the
// whole warp).
template <int BITS, bool ENCODE>
__device__ __forceinline__ int step(State& s, int g, int x, const int* __restrict__ tab) {
    constexpr int R = BITS - 2;
    constexpr int CODE_MASK = (1 << BITS) - 1;
    constexpr int SIGN_BIT = 1 << (BITS - 1);
    constexpr int NQ = (1 << (BITS - 1)) - 1;
    constexpr int DQ_MASK = BITS == 5 ? 0x7FFF : 0x3FFF;

    int i = x & CODE_MASK;
    int row = ENCODE ? 0 : tab[i];  // decode: the code's row, off the chain

    // predictor: this thread's tap, then the group's sums
    const int p = fmult((g < 6 ? s.b : (g == 6 ? s.a0 : s.a1)) >> 2, s.h);
    int pz = g < 6 ? p : 0;
    int pp = g < 6 ? 0 : p;
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
        pz += __shfl_xor_sync(0xFFFFFFFFu, pz, o);
        pp += __shfl_xor_sync(0xFFFFFFFFu, pp, o);
    }
    const int sez = pz >> 1;
    const int se = (pz + pp) >> 1;
    const int y = step_size(s);

    if (ENCODE) {
        const int d = (x >> 2) - se;
        const int dqm = d < 0 ? wneg(d) : d;
        const int e = quan_p2(dqm >> 1);
        const int mant = sar(shl(dqm, 7), e) & 0x7F;
        const int dln = (e << 7) + mant - (y >> 2);
        const int qi = count_le<NQ>(kQ[R], dln);
        i = d < 0 ? CODE_MASK - qi : (qi == 0 ? CODE_MASK : qi);
        row = tab[i];
    }
    const int dqln = (row & 0xFFF) - 2048;
    const int wi = ((row >> 12) & 0x7FF) - 32;
    const int fi = ((row >> 23) & 7) << 9;
    const int dq = reconstruct((i & SIGN_BIT) != 0, dqln, y);
    const int sr = dq < 0 ? se - (dq & DQ_MASK) : se + dq;
    const int dqsez = sr - se + sez;
    update<BITS == 5 ? 9 : 8>(s, g, y, wi * 32, fi, dq, sr, dqsez);
    return ENCODE ? (i & CODE_MASK) : clampi(shl(sr, 2), -32768, 32767);
}

template <int BITS, bool ENCODE>
__global__ void __launch_bounds__(THREADS) g726_scan_kernel(
    const uint8_t* __restrict__ xs, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ st_in, int32_t* __restrict__ st_out, uint8_t* __restrict__ out,
    int B, int N) {
    constexpr int XB = ENCODE ? 2 : 1;  // bytes of an input (sample / code)
    constexpr int OB = ENCODE ? 1 : 2;  // bytes of an output
    // rows padded by a word, so that the lanes' accesses to one step fall
    // in distinct banks
    __shared__ __align__(16) uint8_t x_s[LANES][TILE * XB + 4];
    __shared__ __align__(16) uint8_t v_s[LANES][TILE + 4];
    __shared__ __align__(16) uint8_t o_s[LANES][TILE * OB + 4];
    __shared__ int tab_s[32];

    const int g = threadIdx.x % G;
    const int ll = threadIdx.x / G;
    const int lane0 = blockIdx.x * LANES;
    const int rows = min(LANES, B - lane0);
    const bool live = ll < rows;  // the last block's extra threads step along on a dead state

    if (threadIdx.x < (1 << BITS)) tab_s[threadIdx.x] = pack_code(BITS - 2, threadIdx.x);
    State s{};
    if (live) load_state(st_in + (long)(lane0 + ll) * WIDTH, g, s);
    const uint8_t* x_row = x_s[ll];
    const uint8_t* v_row = v_s[ll];
    uint8_t* o_row = o_s[ll];

    for (int t0 = 0; t0 < N; t0 += TILE) {
        const int nt = min(TILE, N - t0);
        load_rows<THREADS>(&x_s[0][0], TILE * XB + 4, xs + ((long)lane0 * N + t0) * XB, (long)N * XB,
                  rows, nt * XB);
        if (valid) load_rows<THREADS>(&v_s[0][0], TILE + 4, valid + (long)lane0 * N + t0, N, rows, nt);
        cp_async_wait();
        __syncthreads();
        // Every thread runs every step, so the warp never diverges; a
        // masked step's result is dropped. Each step's input and mask are
        // read one step ahead, off the chain.
        auto input = [&](int t) {
            return ENCODE ? (int)reinterpret_cast<const int16_t*>(x_row)[t] : (int)x_row[t];
        };
        auto on = [&](int t) { return live && (valid == nullptr || v_row[t] != 0); };
        int x_next = input(0);
        bool on_next = on(0);
        for (int t = 0; t < nt; ++t) {
            const int x = x_next;
            const bool step_on = on_next;
            x_next = input(min(t + 1, nt - 1));
            on_next = on(min(t + 1, nt - 1));
            State next = s;
            const int y = step<BITS, ENCODE>(next, g, x, tab_s);
            keep(step_on, next, s);
            if (ENCODE)
                o_row[t] = (uint8_t)(step_on ? y : 0);
            else
                reinterpret_cast<int16_t*>(o_row)[t] = (int16_t)(step_on ? y : 0);
        }
        __syncthreads();
        store_rows<THREADS>(out + ((long)lane0 * N + t0) * OB, (long)N * OB, &o_s[0][0], TILE * OB + 4,
                   rows, nt * OB);
    }
    if (live) store_state(st_out + (long)(lane0 + ll) * WIDTH, g, s);
}

template <bool ENCODE>
cudaError_t launch(int bits, const uint8_t* xs, const uint8_t* valid, const int32_t* st_in,
                   int32_t* st_out, uint8_t* out, int B, int N, cudaStream_t stream) {
    const int blocks = (B + LANES - 1) / LANES;
    switch (bits) {
        case 2: g726_scan_kernel<2, ENCODE><<<blocks, THREADS, 0, stream>>>(xs, valid, st_in, st_out, out, B, N); break;
        case 3: g726_scan_kernel<3, ENCODE><<<blocks, THREADS, 0, stream>>>(xs, valid, st_in, st_out, out, B, N); break;
        case 4: g726_scan_kernel<4, ENCODE><<<blocks, THREADS, 0, stream>>>(xs, valid, st_in, st_out, out, B, N); break;
        case 5: g726_scan_kernel<5, ENCODE><<<blocks, THREADS, 0, stream>>>(xs, valid, st_in, st_out, out, B, N); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

// xs: codes u8 [B, N] (decode) or samples i16 [B, N] (encode); valid u8
// [B, N] or null; st_in/st_out i32 [B, 24]; out: samples i16 (decode) or
// codes u8 (encode) [B, N].
extern "C" int skt_g726_scan(const void* xs, const uint8_t* valid, const int32_t* st_in,
                             int32_t* st_out, void* out, int B, int N, int bits, int encode,
                             void* stream) {
    if (B == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    const uint8_t* x = static_cast<const uint8_t*>(xs);
    uint8_t* o = static_cast<uint8_t*>(out);
    return (int)(encode ? launch<true>(bits, x, valid, st_in, st_out, o, B, N, s)
                        : launch<false>(bits, x, valid, st_in, st_out, o, B, N, s));
}
