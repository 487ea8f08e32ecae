// G.722 sub-band ADPCM scan (64 kbit/s mode 1), decode and encode.
//
// Replaces soundkit_tpu/ops/g722.py::g722_decode_scan and
// ::g722_encode_scan (K7): a lax.scan over N codes in which every step
// runs the low-band (6-bit) and high-band (2-bit) ADPCM of one code, the
// shared predictor update of both bands (_block4), the step-size
// adaptation (_scale) and the 24-tap QMF (synthesis on decode, two
// samples out; analysis on encode, two samples in). A masked step
// (valid == 0) freezes the lane's state and writes 0.
//
// The state of a lane is one row of 70 int32 in the fields of the JAX
// package's G722State, in order: x[24] s[2] sp[2] sz[2] r[2][2] p[2][2]
// a[2][2] b[2][6] d[2][6] nb[2] det[2], band 0 = low, 1 = high
// (soundkit_tpu_torch/ops/g722.py::G722_LAYOUT).
//
// Exactness: as in g726.cu, shifts by a variable amount follow XLA's
// rule (shl/sar, xla_int.cuh), and the products and the QMF sums wrap
// through uint32 as XLA's int32 arithmetic does, so every sum may be
// taken in any order. The state is the caller's: nothing here assumes a
// range of it (the ladder of the low band's quantizer is counted, not
// searched, so it is right for a negative step size too).
//
// What bounds it: the per-step dependency chain. The bytes (one code in,
// two samples out, or the reverse) are three orders of magnitude under
// the time. The first design (one thread a lane, 32-thread blocks, the
// whole step on one chain: both bands' predictors, the 22-register shift
// of the QMF line and its 24 products, the encoder's 29-rung ladder;
// codes, masks and samples read and written in place, strided by N; the
// tables in __constant__ memory, indexed by each lane's own code) took
// ~1,500 (decode) and ~1,900 (encode) cycles a step. This one takes
// what the arithmetic allows off the chain, and ~310 and ~480 cycles a
// step (0.32 / 0.50 ms for B = 1024, N = 2048 on an H100 80GB HBM3 at a
// 700 W power limit). What is left is the loop's ~140-160 instructions,
// issued in order by one warp a scheduler: how the compiler orders them
// moves the time by a fifth, so time a change as the source it becomes.
//
// - Tiles through shared memory. A block stages its lanes' TILE codes (or
//   sample pairs) and mask bytes with coalesced loads (tile_rows.cuh) and
//   writes its outputs back the same way; no global access is in the
//   step loop. The tables are shared-memory rows of two words per code,
//   so lanes with different codes do not serialize.
// - Masks are resolved before the steps: a lane's valid steps are
//   compacted (a running count gives step n its position among the valid
//   ones), the scan runs over the compacted steps, and the outputs are
//   scattered back, 0 at a masked step. The kernel's contract is any
//   mask, holes included.
// - The QMF is feed-forward: the delay line never feeds the ADPCM state.
//   The line of a tile is the 24 carried entries followed by one pair per
//   valid step (decode: rlow + rhigh, rlow - rhigh, after the scan;
//   encode: the two samples, before it), and the two 12-tap sums of every
//   step are a plain FIR over it that all threads of the lane compute
//   side by side. Its last 24 entries are the carried line of the next
//   tile.
// - The bands are independent given the code (decode) or xlow / xhigh
//   (encode): each band is a group of G threads, one predictor tap each.
//   Threads 0-5 of a group hold a zero tap (b[k], d[k]), threads 6-7 the
//   pole history r[k - 6]; each forms one product of FILTEZ / FILTEP, the
//   group sums them with __shfl_xor_sync, the history moves one tap up
//   with __shfl_up_sync, and the scalar state (s sp sz p a nb det) is
//   computed by every thread of the group. The encoder's 29 thresholds
//   are spread over the same group, computed from det a step ahead (off
//   the chain through s), and counted by a shuffle sum.
//
// A lane is 2 G = 16 threads, a block one warp of two lanes: B = 1024
// lanes are 512 warps, about one a scheduler on all 132 SMs. Every
// thread runs every step up to the longer of the warp's two lanes, so
// the shuffles see the whole warp; a step past a lane's own count is
// dropped. A tile is staged, then stepped (its TILE steps take far longer
// than its load, so the tiles are not double-buffered); of the tile
// lengths and group widths tried on an H100, TILE = 128 and G = 8 were
// the fastest.

#include <cuda_runtime.h>

#include <cstdint>

#include "tile_rows.cuh"
#include "xla_int.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int G = 8;                 // threads a band, one predictor tap each
constexpr int LANE_THREADS = 2 * G;  // the low band's group, then the high band's
constexpr int LANES = THREADS / LANE_THREADS;  // lanes a block
constexpr int TILE = 128;            // steps staged per tile
constexpr int WIDTH = 70;
constexpr int NQ = (29 + G - 1) / G;  // ladder thresholds a thread
constexpr int CHUNK = TILE / LANE_THREADS;  // steps a thread compacts
constexpr unsigned FULL = 0xFFFFFFFFu;

static_assert(G == 8, "a band's eight predictor taps, one a thread");
static_assert(TILE <= 256 && TILE % LANE_THREADS == 0, "positions in a tile are bytes");

// soundkit_tpu/ops/g722.py
__constant__ int kWL[8] = {-60, -30, 58, 172, 334, 538, 1198, 3042};
__constant__ int kRL42[16] = {0, 7, 6, 5, 4, 3, 2, 1, 7, 6, 5, 4, 3, 2, 1, 0};
__constant__ int kILB[32] = {
    2048, 2093, 2139, 2186, 2233, 2282, 2332, 2383, 2435, 2489, 2543, 2599, 2656, 2714, 2774, 2834,
    2896, 2960, 3025, 3091, 3158, 3228, 3298, 3371, 3444, 3520, 3597, 3676, 3756, 3838, 3922, 4008};
__constant__ int kWH[3] = {0, -214, 798};
__constant__ int kRH2[4] = {2, 1, 2, 1};
__constant__ int kQM2[4] = {-7408, -1616, 7408, 1616};
__constant__ int kQM4[16] = {0, -20456, -12896, -8968, -6288, -4240, -2584, -1200,
                             20456, 12896, 8968, 6288, 4240, 2584, 1200, 0};
__constant__ int kQM6[64] = {
    -136, -136, -136, -136, -24808, -21904, -19008, -16704, -14984, -13512, -12280, -11192,
    -10232, -9360, -8576, -7856, -7192, -6576, -6000, -5456, -4944, -4464, -4008, -3576,
    -3168, -2776, -2400, -2032, -1688, -1360, -1040, -728, 24808, 21904, 19008, 16704,
    14984, 13512, 12280, 11192, 10232, 9360, 8576, 7856, 7192, 6576, 6000, 5456,
    4944, 4464, 4008, 3576, 3168, 2776, 2400, 2032, 1688, 1360, 1040, 728,
    432, 136, -432, -136};
__constant__ int kQMF[12] = {3, -11, 12, 32, -210, 951, 3876, -805, 362, -156, 53, -11};
__constant__ int kQ6[32] = {
    0, 35, 72, 110, 150, 190, 233, 276, 323, 370, 422, 473, 530, 587, 650, 714,
    786, 858, 940, 1023, 1121, 1219, 1339, 1458, 1612, 1765, 1980, 2195, 2557, 2919, 0, 0};
__constant__ int kILN[32] = {0, 63, 62, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19,
                             18, 17, 16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 0};
__constant__ int kILP[32] = {0, 61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 51, 50, 49, 48, 47,
                             46, 45, 44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33, 32, 0};
__constant__ int kIHN[3] = {0, 1, 0};
__constant__ int kIHP[3] = {0, 3, 2};

__device__ __forceinline__ int sat16(int v) { return clampi(v, -32768, 32767); }

// A band's table row for one index, two words. x: the inverse quantizer's
// output QM4[ril] / QM2[ihigh] that drives the predictor (low 16 bits) and
// the log scale factor's step WL[RL42[ril]] / WH[RH2[ihigh]] (high 16
// bits). Decode indexes by the band's code bits (low: the 6-bit code, y =
// QM6[code], the finer output that only rlow takes; high: the 2-bit
// code). Encode indexes by 32 * (difference < 0) + ladder level, y = the
// band's code bits (ILN / ILP, IHN / IHP).
__device__ __forceinline__ int2 table_row(bool encode, bool high, int idx) {
    const int level = idx & 31;
    int code = idx;
    if (encode)
        code = high ? (level < 3 ? (idx >= 32 ? kIHN[level] : kIHP[level]) : 0)
                    : (idx >= 32 ? kILN[level] : kILP[level]);
    const int j = high ? code & 3 : (code & 63) >> 2;
    const int qm = high ? kQM2[j] : kQM4[j];
    const int w = high ? kWH[kRH2[j]] : kWL[kRL42[j]];
    return make_int2((qm & 0xFFFF) | (w << 16), encode ? code : (high ? 0 : kQM6[code & 63]));
}

// What a thread holds of its band: the scalars (the same on every thread
// of the band's group) and tap g of the eight: g < 6 is zero tap g (b[g],
// h = d[g]), g = 6 and 7 are the pole history (h = r[g - 6]; b unused,
// kept 0). thr: this thread's share of the encoder's ladder, (Q6[k] *
// det) >> 12 for the det held.
struct Band {
    int s, sp, sz, p0, p1, a0, a1, nb, det;
    int b, h;
    int thr[NQ];
};

__device__ __forceinline__ void load_band(const int32_t* p, int band, int g, Band& q) {
    q.s = p[24 + band];
    q.sp = p[26 + band];
    q.sz = p[28 + band];
    q.p0 = p[34 + 2 * band];
    q.p1 = p[35 + 2 * band];
    q.a0 = p[38 + 2 * band];
    q.a1 = p[39 + 2 * band];
    q.nb = p[66 + band];
    q.det = p[68 + band];
    q.b = g < 6 ? p[42 + 6 * band + g] : 0;
    q.h = g < 6 ? p[54 + 6 * band + g] : p[30 + 2 * band + g - 6];
}

__device__ __forceinline__ void store_band(int32_t* p, int band, int g, const Band& q) {
    if (g == 0) {
        p[24 + band] = q.s;
        p[26 + band] = q.sp;
        p[28 + band] = q.sz;
        p[34 + 2 * band] = q.p0;
        p[35 + 2 * band] = q.p1;
        p[38 + 2 * band] = q.a0;
        p[39 + 2 * band] = q.a1;
        p[66 + band] = q.nb;
        p[68 + band] = q.det;
    }
    if (g < 6) {
        p[42 + 6 * band + g] = q.b;
        p[54 + 6 * band + g] = q.h;
    } else {
        p[30 + 2 * band + g - 6] = q.h;
    }
}

// q = on ? next : q, field by field with selects (no branch: the warp
// stays whole for the shuffles)
__device__ __forceinline__ void keep(bool on, const Band& next, Band& q) {
    q.s = on ? next.s : q.s;
    q.sp = on ? next.sp : q.sp;
    q.sz = on ? next.sz : q.sz;
    q.p0 = on ? next.p0 : q.p0;
    q.p1 = on ? next.p1 : q.p1;
    q.a0 = on ? next.a0 : q.a0;
    q.a1 = on ? next.a1 : q.a1;
    q.nb = on ? next.nb : q.nb;
    q.det = on ? next.det : q.det;
    q.b = on ? next.b : q.b;
    q.h = on ? next.h : q.h;
#pragma unroll
    for (int i = 0; i < NQ; ++i) q.thr[i] = on ? next.thr[i] : q.thr[i];
}

// the sum of v over the band's group
__device__ __forceinline__ int group_sum(int v) {
#pragma unroll
    for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// SCALEL / SCALEH: nb -> det
__device__ __forceinline__ int scale(int nb, bool high, const int* __restrict__ ilb) {
    const int base = ilb[(nb >> 6) & 31];
    const int wd2 = (high ? 10 : 8) - (nb >> 11);
    return shl(wd2 < 0 ? shl(base, -wd2) : sar(base, wd2), 2);
}

// this thread's thresholds of the ladder for step size det: qk holds its
// Q6 entries (564 for the high band's one level)
__device__ __forceinline__ void ladder(Band& q, const int (&qk)[NQ]) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) q.thr[i] = wmul(qk[i], q.det) >> 12;
}

// One step of one band; every thread of the warp calls it. Decode: row
// is the table row of the band's code bits; returns the band's output
// (rlow or rhigh). Encode: x is the band's input (xlow or xhigh), nq
// counts this thread's live thresholds; returns the band's code bits.
template <bool ENCODE>
__device__ __forceinline__ int band_step(Band& q, int g, bool high, int x, int2 row,
                                         const int2* __restrict__ tab,
                                         const int* __restrict__ ilb, const int (&qk)[NQ],
                                         int nq) {
    if (ENCODE) {
        // quantize the difference: 1 + the count of thresholds at or under wd
        const int e = sat16((int)((unsigned)x - (unsigned)q.s));
        const int wd = e >= 0 ? e : -(e + 1);
        int c = 0;
#pragma unroll
        for (int i = 0; i < NQ; ++i) c += (i < nq && wd >= q.thr[i]) ? 1 : 0;
        row = tab[(e < 0 ? 32 : 0) + 1 + group_sum(c)];
    }
    const int d = wmul(q.det, (int)(int16_t)(row.x & 0xFFFF)) >> 15;
    // decode's output: the low band's takes the 6-bit inverse quantizer
    const int out = clampi(q.s + (high ? d : wmul(q.det, row.y) >> 15), -16384, 16383);

    // LOGSCL / LOGSCH, SCALEL / SCALEH, and the next step's ladder
    const int nb = clampi((wmul(q.nb, 127) >> 7) + (row.x >> 16), 0, high ? 22528 : 18432);
    q.nb = nb;
    q.det = scale(nb, high, ilb);
    if (ENCODE) ladder(q, qk);

    // BLOCK4: the poles (UPPOL2, UPPOL1), on every thread
    const int r0 = sat16(q.s + d);
    const int p0 = sat16(q.sz + d);
    const int sg0 = p0 >> 15, sg1 = q.p0 >> 15, sg2 = q.p1 >> 15;
    const int wd1 = sat16(shl(q.a0, 2));
    const int wd2 = min(sg0 == sg1 ? -wd1 : wd1, 32767);
    const int wd3 = (wd2 >> 7) + (sg0 == sg2 ? 128 : -128) + (wmul(q.a1, 32512) >> 15);
    const int ap2 = clampi(wd3, -12288, 12288);
    const int ap1u = sat16((sg0 == sg1 ? 192 : -192) + (wmul(q.a0, 32640) >> 15));
    const int wd3b = sat16(15360 - ap2);
    const int ap1 = min(max(ap1u, -wd3b), wd3b);

    // this thread's tap: UPZERO on the old history, DELAY, then the tap's
    // product of FILTEZ (a zero tap) or FILTEP (the pole history)
    const bool zero = g < 6;
    const int wd1c = d == 0 ? 0 : 128;
    const int bn = sat16(((q.h >> 15) == (d >> 15) ? wd1c : -wd1c) + (wmul(q.b, 32640) >> 15));
    const int moved = __shfl_up_sync(FULL, q.h, 1, G);
    q.b = zero ? bn : 0;
    q.h = g == 0 ? d : (g == 6 ? r0 : moved);
    const int term = wmul(zero ? bn : (g == 6 ? ap1 : ap2), sat16(shl(q.h, 1))) >> 15;
    // the group's two sums side by side, so that each round's two
    // shuffles are in flight together
    int pp = zero ? 0 : term, pz = zero ? term : 0;
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
        const int up = __shfl_xor_sync(FULL, pp, o), uz = __shfl_xor_sync(FULL, pz, o);
        pp += up;
        pz += uz;
    }
    q.sp = sat16(pp);
    q.sz = sat16(pz);
    q.s = sat16(q.sp + q.sz);
    q.p1 = q.p0;
    q.p0 = p0;
    q.a0 = ap1;
    q.a1 = ap2;
    return ENCODE ? row.y : out;
}

// (sum over even taps, sum over odd taps) of 24 entries of the delay
// line, wrapping
__device__ __forceinline__ void qmf(const int* __restrict__ x, int& even, int& odd) {
    unsigned e = 0, o = 0;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
        e += (unsigned)x[2 * k] * (unsigned)kQMF[k];
        o += (unsigned)x[2 * k + 1] * (unsigned)kQMF[11 - k];
    }
    even = (int)e;
    odd = (int)o;
}

template <bool ENCODE>
__global__ void __launch_bounds__(THREADS) g722_scan_kernel(
    const uint8_t* __restrict__ xs, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ st_in, int32_t* __restrict__ st_out, uint8_t* __restrict__ out,
    int B, int N) {
    constexpr int XB = ENCODE ? 4 : 1;  // bytes a step reads (a sample pair / a code)
    constexpr int OB = ENCODE ? 1 : 4;  // bytes a step writes
    // rows padded by a word, so that the lanes' accesses to one step fall
    // in distinct banks
    __shared__ __align__(16) uint8_t x_s[LANES][TILE * XB + 4];
    __shared__ __align__(16) uint8_t v_s[LANES][TILE + 4];
    __shared__ __align__(16) uint8_t o_s[LANES][TILE * OB + 4];
    __shared__ uint8_t pos_s[LANES][TILE];  // a valid step's position among the valid ones
    __shared__ uint8_t code_s[LANES][TILE];  // decode: the valid steps' codes
    __shared__ int line_s[LANES][24 + 2 * TILE + 1];  // the QMF line of the tile
    __shared__ int carry_s[LANES][24];                // the carried QMF line, x[24]
    // per band and valid step: encode xlow / xhigh in, code bits out;
    // decode rlow / rhigh out
    __shared__ int io_s[LANES][2][TILE];
    __shared__ int2 tab_s[2][64];
    __shared__ int ilb_s[32];

    const int ll = threadIdx.x / LANE_THREADS;  // lane of the block
    const int u = threadIdx.x % LANE_THREADS;   // thread of the lane
    const bool high = u >= G;
    const int g = u % G;
    const int lane0 = blockIdx.x * LANES;
    const int rows = min(LANES, B - lane0);
    const bool live = ll < rows;  // the last block's extra threads step along on a dead state

    for (int i = threadIdx.x; i < 128; i += THREADS)
        tab_s[i >> 6][i & 63] = table_row(ENCODE, i >= 64, i & 63);
    for (int i = threadIdx.x; i < 32; i += THREADS) ilb_s[i] = kILB[i];

    Band q{};
    int qk[NQ];
    int nq = 0;  // thresholds 1 + g * NQ + i of the ladder: 29 in the low band, 1 in the high
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
        const int k = 1 + g * NQ + i;
        qk[i] = high ? 564 : kQ6[min(k, 31)];
        nq += k <= (high ? 1 : 29);
    }
    if (live) {
        const int32_t* p = st_in + (long)(lane0 + ll) * WIDTH;
        load_band(p, high, g, q);
        for (int k = u; k < 24; k += LANE_THREADS) carry_s[ll][k] = p[k];
    }
    if (ENCODE) ladder(q, qk);
    const uint8_t* x_row = x_s[ll];
    const uint8_t* v_row = v_s[ll];
    uint8_t* o_row = o_s[ll];
    int* line = line_s[ll];
    int* io = io_s[ll][high];
    const int2* tab = tab_s[high];

    for (int t0 = 0; t0 < N; t0 += TILE) {
        const int nt = min(TILE, N - t0);
        load_rows<THREADS>(&x_s[0][0], TILE * XB + 4, xs + ((long)lane0 * N + t0) * XB,
                           (long)N * XB, rows, nt * XB);
        if (valid)
            load_rows<THREADS>(&v_s[0][0], TILE + 4, valid + (long)lane0 * N + t0, N, rows, nt);
        cp_async_wait();
        __syncthreads();

        // compact: each thread counts the valid steps of its CHUNK, a
        // prefix sum over the lane's threads gives its first position,
        // then it gathers its valid steps' inputs (decode: the code;
        // encode: the sample pair, straight into the QMF line)
        auto on = [&](int n) { return live && n < nt && (valid == nullptr || v_row[n] != 0); };
        int count = 0;
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) count += on(u * CHUNK + i);
        int upto = count;
#pragma unroll
        for (int o = 1; o < LANE_THREADS; o <<= 1) {
            const int below = __shfl_up_sync(FULL, upto, o, LANE_THREADS);
            upto += u >= o ? below : 0;
        }
        const int m = __shfl_sync(FULL, upto, LANE_THREADS - 1, LANE_THREADS);  // the lane's valid steps
        int at = upto - count;
        for (int i = 0; i < CHUNK; ++i) {
            const int n = u * CHUNK + i;
            if (on(n)) {
                pos_s[ll][n] = (uint8_t)at;
                if (ENCODE) {
                    line[24 + 2 * at] = reinterpret_cast<const int16_t*>(x_row)[2 * n];
                    line[25 + 2 * at] = reinterpret_cast<const int16_t*>(x_row)[2 * n + 1];
                } else {
                    code_s[ll][at] = x_row[n];
                }
                ++at;
            }
        }
        for (int k = u; k < 24; k += LANE_THREADS) line[k] = carry_s[ll][k];
        __syncthreads();

        if (ENCODE) {
            // analysis QMF of every valid step: xlow, xhigh
            for (int j = u; j < m; j += LANE_THREADS) {
                int even, odd;
                qmf(line + 2 * (j + 1), even, odd);
                io_s[ll][0][j] = (int)((unsigned)even + (unsigned)odd) >> 14;
                io_s[ll][1][j] = (int)((unsigned)even - (unsigned)odd) >> 14;
            }
            __syncthreads();
        }

        // the scan over the valid steps; each step's input is read one
        // step ahead, off the chain
        const int steps = __reduce_max_sync(FULL, m);
        auto input = [&](int j) {
            return ENCODE ? io[j] : (high ? code_s[ll][j] >> 6 : code_s[ll][j] & 63);
        };
        auto lookup = [&](int x) { return ENCODE ? make_int2(0, 0) : tab[x]; };
        int x_next = input(0);
        int2 row_next = lookup(x_next);
        for (int j = 0; j < steps; ++j) {
            const int x = x_next;
            const int2 row = row_next;
            x_next = input(min(j + 1, TILE - 1));
            row_next = lookup(x_next);
            Band next = q;
            const int y = band_step<ENCODE>(next, g, high, x, row, tab, ilb_s, qk, nq);
            const bool step_on = j < m;
            keep(step_on, next, q);
            if (g == 0 && step_on) io[j] = y;
        }
        __syncthreads();

        if (ENCODE) {
            for (int n = u; n < nt; n += LANE_THREADS) {
                const int j = pos_s[ll][n];
                o_row[n] = on(n) ? (uint8_t)((io_s[ll][1][j] << 6) | io_s[ll][0][j]) : 0;
            }
        } else {
            // the QMF line's new pairs, then the synthesis QMF of every
            // valid step, scattered to the step's place
            for (int j = u; j < m; j += LANE_THREADS) {
                const int rlow = io_s[ll][0][j], rhigh = io_s[ll][1][j];
                line[24 + 2 * j] = rlow + rhigh;
                line[25 + 2 * j] = rlow - rhigh;
            }
            __syncthreads();
            for (int n = u; n < nt; n += LANE_THREADS) {
                int even = 0, odd = 0;
                const bool step_on = on(n);
                if (step_on) qmf(line + 2 * (pos_s[ll][n] + 1), even, odd);
                int16_t* pcm = reinterpret_cast<int16_t*>(o_row) + 2 * n;
                pcm[0] = step_on ? (int16_t)sat16(odd >> 11) : 0;
                pcm[1] = step_on ? (int16_t)sat16(even >> 11) : 0;
            }
        }
        // the line's last 24 entries carry over
        for (int k = u; k < 24; k += LANE_THREADS) carry_s[ll][k] = line[2 * m + k];
        __syncthreads();
        store_rows<THREADS>(out + ((long)lane0 * N + t0) * OB, (long)N * OB, &o_s[0][0],
                            TILE * OB + 4, rows, nt * OB);
    }
    if (live) {
        int32_t* p = st_out + (long)(lane0 + ll) * WIDTH;
        store_band(p, high, g, q);
        for (int k = u; k < 24; k += LANE_THREADS) p[k] = carry_s[ll][k];
    }
}

}  // namespace

// xs: codes u8 [B, N] (decode) or samples i16 [B, 2N] (encode); valid u8
// [B, N] (one flag per code) or null; st_in/st_out i32 [B, 70]; out:
// samples i16 [B, 2N] (decode) or codes u8 [B, N] (encode).
extern "C" int skt_g722_scan(const void* xs, const uint8_t* valid, const int32_t* st_in,
                             int32_t* st_out, void* out, int B, int N, int encode, void* stream) {
    if (B == 0) return 0;
    const int blocks = (B + LANES - 1) / LANES;
    const cudaStream_t s = (cudaStream_t)stream;
    const uint8_t* x = static_cast<const uint8_t*>(xs);
    uint8_t* o = static_cast<uint8_t*>(out);
    if (encode)
        g722_scan_kernel<true><<<blocks, THREADS, 0, s>>>(x, valid, st_in, st_out, o, B, N);
    else
        g722_scan_kernel<false><<<blocks, THREADS, 0, s>>>(x, valid, st_in, st_out, o, B, N);
    return (int)cudaGetLastError();
}
