// K14: the analysis of one FLAC block for every row (the plan of the batched
// encoder): soundkit_tpu/ops/flac_enc_batch.py::flac_analyze_device (an XLA map
// there, no Pallas kernel).
//
// Inputs: the wire x [rows, 2, N], int16 (<= 16-bit streams) or int32, widened
// here; n_valid (the samples present, the same for every row), the bit depth and
// the channel count. Output: one int32 plan row a block, [rows, 23]: assign,
// kind[2], order[2], shift[2], qlp[2 x 8] (ops.flac_enc_batch.flac_plans_unpack).
// Per candidate (L, R, S = L - R, M = (L + R) >> 1; L alone for mono): the fixed
// order 0-4 with the least sum |residual| (the first on a tie) and its Rice
// estimate; the Welch-windowed float64 autocorrelation at lags 0-8, an 8-step
// Levinson-Durbin, the coefficients quantized to precision 14, the exact integer
// order-8 residual and its Rice estimate; then fixed or LPC (LPC only if strictly
// cheaper), and the assignment with the least summed cost (the first on a tie).
//
// What bounds it on the card: operations, not bytes: a row of 4096 stereo int16
// samples is 16 KB read once, against ~20 float64 and ~40 integer operations a
// sample and candidate (kernel_check.flac_analyze_work). On this card integer
// and float64 instructions each issue at 64 lanes a clock an SM, half the issue
// rate, and no float64 product or sum may fuse into an FMA, so the design keeps
// every instruction that is not the algorithm's out of the loops:
// - A persistent grid (SMs x resident blocks, Occupancy<T>): a block stays on its
//   SM and walks rows, THREADS threads a row, so the Welch window of n_valid (a
//   float64 division a sample) is built once a block in shared memory; only
//   rows longer than one TILE build it again for each tile.
// - A thread reads its SPT samples of L and R and the ORDER before them once a
//   row into registers (two int16 a word on an int16 wire) and builds each
//   candidate from them. An int32 becomes a float64 by one DADD on its bits
//   (I2F.F64 runs at a quarter of DMUL's rate), and each windowed value is
//   computed once: a thread's windowed samples 8..15 go through a shared line
//   (double-buffered by candidate) to the next thread, the halo of its lags.
// - Integer sums are exact in any order: 32-bit where the wire allows it (16
//   |d_4| of a thread stay below 2^32), |d_o| + sum one __sad (VABSDIFF), a warp
//   summed by one __reduce_add_sync, the counts of negative differences three
//   to a word.
// - The nine lags' warp trees run at once (warp_dsum9): a warp shuffles and
//   adds 12 values where nine plain trees take 45, in the same order.
// - Pass B's LPC taps: on an int16 wire with shift >= 2 (all but degenerate
//   fits) two 32-bit sums of four taps, exact, and a 32-bit residual;
//   otherwise an IMAD.WIDE a tap (mad.wide.s32: nvcc makes the C++ product of
//   two widened ints three instructions) and 64-bit arithmetic.
// - Pass B keeps each thread's LPC zigzag residuals in the shared line, so
//   pass C only shifts and sums them; a thread whose residual needs more than
//   32 bits, and rows longer than a tile, predict again.
// - The Rice parameter without a 64-bit division (rice_k).
// - The Levinson recursion runs on one thread a candidate while the block
//   waits; the other resident blocks keep the SM busy.
// A row in order: pass A (per candidate: the fixed sums and the line, a
// barrier, the autocorrelation), the finalize (one thread a candidate: the
// fixed order and its Rice parameter, the Levinson recursion, the
// quantization), pass B (per candidate: the chosen fixed residual's
// sum(u >> k), the LPC residuals and their zigzag total, a barrier), pass C
// (the LPC sum(u >> k)), the plan row.
//
// Where the plain version (ops.flac_enc_batch.flac_analyze_plain) and this
// kernel must agree:
// - FMA contraction: nvcc would fuse 1 - t*t, x*w and acc + a*b into FMAs, which
//   round once where the reference rounds twice. Every float64 product and sum
//   here is __dmul_rn / __dadd_rn / __dsub_rn, in the reference's order; the
//   division is IEEE (CUDA's double division is correctly rounded).
// - Sum order: the autocorrelation sums cannot follow the reference's order
//   (XLA's). The Levinson recursion on a Welch-windowed tone is ill-conditioned
//   enough that another order moves a quantized coefficient (by one at 2^11 on
//   a 24-bit sine over 9000 samples), not only at a rounding tie, so the plain
//   version sums in this kernel's order (ops.flac_enc_batch.autocorrelation,
//   AC_SPT = SPT, AC_WARPS = WARPS): a thread's SPT samples in turn, the 32 lanes
//   of a warp by the halving tree of __shfl_down_sync, the warps in turn, the
//   tiles in turn. The Levinson sums run left to right in both.
// - Rounding: the reference rounds half to even (jnp.round): rint here,
//   torch.round there.
// - Bit lengths: the reference takes floor(log2) of a float64; here __clzll for
//   the Rice mean and ilogb for max|a|, exact (so is the plain version).
// - Signed shifts: u = (r << 1) ^ (r >> 63) shifts left as uint64 (a left shift
//   of a negative int64 is undefined in C++); >> stays arithmetic for M,
//   pred >> shift and r >> 63.
// - Ties: the fixed order and the assignment take the first minimum; LPC wins
//   only if strictly cheaper.
// - The no-LPC sentinel: the LPC cost is 1 << 50 unless err > 0 through the
//   recursion, some qlp != 0 and n_valid > 16 (silence and a constant block
//   fail here).
// - Mono: channel 1 of the wire is zero and ignored; assign 0, both slots L.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SPT = 16;                  // consecutive samples a thread takes in a tile
constexpr int TILE = THREADS * SPT;      // samples a tile
constexpr int WARPS = THREADS / 32;
constexpr int ORDER = 8;                 // LPC order, and the history a thread keeps
constexpr int HIST = ORDER + SPT;        // a thread's slots: the ORDER samples before, its own
constexpr int PRECISION = 14;
constexpr int NFIX = 5;                  // fixed orders 0..4
constexpr int NLAG = ORDER + 1;
constexpr int NCAND = 4;
constexpr int PLAN = 23;
constexpr long long NO_LPC = 1LL << 50;
constexpr unsigned FULL = 0xffffffffu;

// resident blocks an SM each instance is built for (its register budget): the
// int32 wire keeps twice the samples in registers
template <typename T> struct Occupancy { static constexpr int blocks = sizeof(T) == 2 ? 3 : 2; };

// 16-byte chunk k of a thread's row in shared memory, swizzled so that the 8
// threads of a quarter warp hit 8 different bank groups: rows of 8 chunks
// (128 B) and of 4 (64 B)
__device__ __forceinline__ int sw8(int t, int k) { return k ^ (t & 7); }
__device__ __forceinline__ int sw4(int t, int k) { return k ^ ((t >> 1) & 3); }

struct Shared {
    double2 w[THREADS][SPT / 2];         // the window at each thread's samples
    union {
        double2 xw[2][THREADS][ORDER / 2];   // pass A: windowed samples 8..15, by candidate parity
        uint4 u[2][THREADS][SPT / 4];        // pass B -> C: a thread's own LPC zigzag residuals
    } line;
    double2 prev[2][NCAND][ORDER / 2];   // the last thread's windowed samples 8..15, by tile parity
    unsigned long long ired[NCAND][WARPS][2 * NFIX];   // a warp's fixed sums and negatives
    double dred[NCAND][WARPS][NLAG];     // a warp's autocorrelation
    double ac[NCAND][NLAG];
    unsigned long long bred[NCAND][WARPS][2];   // a warp's fixed sum(u >> k), LPC zigzag total
    unsigned cred[NCAND][WARPS];         // a warp's LPC sum(u >> k)
    int fo[NCAND], fk[NCAND], lk[NCAND], shift[NCAND], ok[NCAND];
    int qlp[NCAND][ORDER];
};

// a thread's samples g0 - ORDER .. g0 + SPT - 1 of L and R, zero outside
// [0, n_valid); slot i holds sample g0 - ORDER + i
template <typename T> struct Wire;

template <> struct Wire<int16_t> {
    uint32_t l[HIST / 2], r[HIST / 2];   // two samples a word, the earlier in the low half
    __device__ __forceinline__ int L(int i) const { return half(l[i >> 1], i & 1); }
    __device__ __forceinline__ int R(int i) const { return half(r[i >> 1], i & 1); }
    static __device__ __forceinline__ int half(uint32_t v, int hi) {
        return hi ? (int)v >> 16 : (int)(int16_t)(uint16_t)v;
    }
    static __device__ __forceinline__ void get(uint32_t (&d)[HIST / 2], const int16_t* p, int g0) {
        const uint4 h = g0 ? __ldg(reinterpret_cast<const uint4*>(p + g0 - ORDER))
                           : make_uint4(0, 0, 0, 0);
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(p + g0));
        const uint4 b = __ldg(reinterpret_cast<const uint4*>(p + g0 + 8));
        d[0] = h.x, d[1] = h.y, d[2] = h.z, d[3] = h.w;
        d[4] = a.x, d[5] = a.y, d[6] = a.z, d[7] = a.w;
        d[8] = b.x, d[9] = b.y, d[10] = b.z, d[11] = b.w;
    }
    static __device__ __forceinline__ void gather(uint32_t (&d)[HIST / 2], const int16_t* p, int g0,
                                                  int n_valid) {
#pragma unroll
        for (int j = 0; j < HIST / 2; j++) {
            const int g = g0 - ORDER + 2 * j;
            const uint32_t lo = g >= 0 && g < n_valid ? (uint16_t)p[g] : 0u;
            const uint32_t hi = g + 1 >= 0 && g + 1 < n_valid ? (uint16_t)p[g + 1] : 0u;
            d[j] = lo | hi << 16;
        }
    }
    __device__ __forceinline__ void load(const int16_t* xl, const int16_t* xr, int g0, int n_valid,
                                         bool vec, bool mono) {
        if (vec && g0 + SPT <= n_valid) {
            get(l, xl, g0);
            if (!mono) get(r, xr, g0);
        } else {
            gather(l, xl, g0, n_valid);
            if (!mono) gather(r, xr, g0, n_valid);
        }
        if (mono) {
#pragma unroll
            for (int j = 0; j < HIST / 2; j++) r[j] = 0;
        }
    }
};

template <> struct Wire<int32_t> {
    int32_t l[HIST], r[HIST];
    __device__ __forceinline__ int L(int i) const { return l[i]; }
    __device__ __forceinline__ int R(int i) const { return r[i]; }
    static __device__ __forceinline__ void get(int32_t (&d)[HIST], const int32_t* p, int g0) {
#pragma unroll
        for (int k = 0; k < HIST / 4; k++) {
            const uint4 a = k < ORDER / 4 && !g0
                ? make_uint4(0, 0, 0, 0)
                : __ldg(reinterpret_cast<const uint4*>(p + g0 - ORDER + 4 * k));
            d[4 * k] = (int32_t)a.x, d[4 * k + 1] = (int32_t)a.y;
            d[4 * k + 2] = (int32_t)a.z, d[4 * k + 3] = (int32_t)a.w;
        }
    }
    static __device__ __forceinline__ void gather(int32_t (&d)[HIST], const int32_t* p, int g0,
                                                  int n_valid) {
#pragma unroll
        for (int i = 0; i < HIST; i++) {
            const int g = g0 - ORDER + i;
            d[i] = g >= 0 && g < n_valid ? p[g] : 0;
        }
    }
    __device__ __forceinline__ void load(const int32_t* xl, const int32_t* xr, int g0, int n_valid,
                                         bool vec, bool mono) {
        if (vec && g0 + SPT <= n_valid) {
            get(l, xl, g0);
            if (!mono) get(r, xr, g0);
        } else {
            gather(l, xl, g0, n_valid);
            if (!mono) gather(r, xr, g0, n_valid);
        }
        if (mono) {
#pragma unroll
            for (int i = 0; i < HIST; i++) r[i] = 0;
        }
    }
};

template <int C, typename W>
__device__ __forceinline__ int candidate(const W& w, int i) {
    if (C == 0) return w.L(i);
    if (C == 1) return w.R(i);
    if (C == 2) return w.L(i) - w.R(i);
    return (w.L(i) + w.R(i)) >> 1;
}

// v[i] = candidate c at slots LO..HI-1
template <int LO, int HI, typename W>
__device__ __forceinline__ void build(const W& w, int c, int (&v)[HIST]) {
    switch (c) {
        case 0:
#pragma unroll
            for (int i = LO; i < HI; i++) v[i] = candidate<0>(w, i);
            break;
        case 1:
#pragma unroll
            for (int i = LO; i < HI; i++) v[i] = candidate<1>(w, i);
            break;
        case 2:
#pragma unroll
            for (int i = LO; i < HI; i++) v[i] = candidate<2>(w, i);
            break;
        default:
#pragma unroll
            for (int i = LO; i < HI; i++) v[i] = candidate<3>(w, i);
    }
}

__device__ __forceinline__ int bit_length(unsigned long long v) {
    return v ? 64 - __clzll((long long)v) : 0;
}

// the reference's Rice parameter from a zigzag sum over n samples,
// k = max(bit_length(tot // max(n, 1)) - 2, 0), without a division: the mean
// is at least 2^j exactly when tot >= n 2^j
__device__ __forceinline__ int rice_k(unsigned long long tot, long long n) {
    const unsigned long long d = n > 1 ? (unsigned long long)n : 1ull;
    if (tot < d) return 0;
    int j = bit_length(tot) - bit_length(d);
    if ((d << j) > tot) j--;
    return j > 1 ? j - 1 : 0;            // bit_length(mean) = j + 1
}

// a * b + c with the 32-bit product widened: one IMAD.WIDE (nvcc makes the
// plain C++ a 64 x 64 product of sign-extended words, three instructions)
__device__ __forceinline__ long long mad_wide(int a, int b, long long c) {
    long long r;
    asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(c));
    return r;
}

__device__ __forceinline__ unsigned long long zigzag(long long r) {
    return ((unsigned long long)r << 1) ^ (unsigned long long)(r >> 63);
}

// the halving tree of __shfl_down_sync (offsets 16, 8, 4, 2, 1) of the nine lags
// at once, its additions spread over the lanes the plain tree leaves idle: at
// each level a lane keeps the lags of its half, takes its partner's values of
// them and adds them to its own (an IEEE sum is the same either way round), so
// a warp shuffles 12 values, not 45; lag k's sum ends at the even lane 2 i with
// LAG_OF_PAIR's nibble i equal to k. Returns this lane's lag (NLAG for none).
constexpr unsigned long long LAG_OF_PAIR = 0xFFF8F765FF43F210ull;

__device__ __forceinline__ int warp_dsum9(const double (&a)[NLAG], int lane, double& out) {
    const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4, h2 = lane & 2;
    double b[5];                         // lanes below 16: lags 0..4; above: 5..8
#pragma unroll
    for (int j = 0; j < 5; j++) {
        const double send = j < 4 ? (h16 ? a[j] : a[5 + j]) : a[4];
        const double own = j < 4 ? (h16 ? a[5 + j] : a[j]) : a[4];
        b[j] = __dadd_rn(own, __shfl_xor_sync(FULL, send, 16));
    }
    double c[3];                         // lane bit 8 clear: slots 0..2; set: 3, 4
#pragma unroll
    for (int j = 0; j < 3; j++) {
        const double send = j < 2 ? (h8 ? b[j] : b[3 + j]) : b[2];
        const double own = j < 2 ? (h8 ? b[3 + j] : b[j]) : b[2];
        c[j] = __dadd_rn(own, __shfl_xor_sync(FULL, send, 8));
    }
    double d[2];                         // lane bit 4 clear: slots 0, 1; set: 2
    d[0] = __dadd_rn(h4 ? c[2] : c[0], __shfl_xor_sync(FULL, h4 ? c[0] : c[2], 4));
    d[1] = __dadd_rn(c[1], __shfl_xor_sync(FULL, c[1], 4));
    const double e = __dadd_rn(h2 ? d[1] : d[0], __shfl_xor_sync(FULL, h2 ? d[0] : d[1], 2));
    out = __dadd_rn(e, __shfl_xor_sync(FULL, e, 1));
    const int lag = (int)(LAG_OF_PAIR >> (4 * (lane >> 1)) & 15);
    return lane & 1 || lag >= NLAG ? NLAG : lag;
}

// a warp's sum of 32-bit values; on an int16 wire a thread's values stay below
// 2^25 and one reduction does, else the halves go apart
template <typename T>
__device__ __forceinline__ unsigned long long warp_total(uint32_t v) {
    if (sizeof(T) == 2) return __reduce_add_sync(FULL, v);
    return ((unsigned long long)__reduce_add_sync(FULL, v >> 16) << 16) +
           __reduce_add_sync(FULL, v & 0xffffu);
}

// an int32 as float64, exactly: 2^52 + 2^31 + v assembled in the bits, less
// 2^52 + 2^31 (one DADD)
__device__ __forceinline__ double to_double(int v) {
    return __dsub_rn(__hiloint2double(0x43300000, v ^ (int)0x80000000), 4503601774854144.0);
}

// the Welch window at sample g of a block of n_valid samples, rounded as the
// reference: t = (2g - (n - 1)) / max(n - 1, 1), w = 1 - t t
__device__ __forceinline__ double welch(int g, int n_valid) {
    const double den = (double)(n_valid - 1 > 1 ? n_valid - 1 : 1);
    const double t = __dsub_rn(2.0 * g, (double)(n_valid - 1)) / den;
    return __dsub_rn(1.0, __dmul_rn(t, t));
}

// the window at the thread's samples of the tile at tile0 (zero from n_valid on)
__device__ void fill_window(Shared& s, int tid, int tile0, int n_valid) {
    for (int k = 0; k < SPT / 2; k++) {
        const int g = tile0 + tid * SPT + 2 * k;
        s.w[tid][sw8(tid, k)] = make_double2(g < n_valid ? welch(g, n_valid) : 0.0,
                                             g + 1 < n_valid ? welch(g + 1, n_valid) : 0.0);
    }
}

// pass A's fixed sums at the thread's samples: |d_o| and the count of d_o < 0 for
// o = 0..4, at samples g >= o (only the block's first thread has g < 4) below
// n_valid (only a tail thread, TAIL, has lim = n_valid - g0 < SPT); |d_o| + sum
// is one __sad of two order-(o - 1) differences
template <bool TAIL>
__device__ __forceinline__ void fixed_sums(const int (&v)[HIST], bool first, int lim,
                                           uint32_t (&fa)[NFIX], uint32_t (&fn)[NFIX]) {
    int d[NFIX - 1] = {};                // order-o differences at the slot before
#pragma unroll
    for (int i = ORDER - 4; i < HIST; i++) {
        int e[NFIX];
        e[0] = v[i];
#pragma unroll
        for (int o = 1; o < NFIX; o++) e[o] = e[o - 1] - d[o - 1];
        const int m = i - ORDER;
        if (m >= 0) {
#pragma unroll
            for (int o = 0; o < NFIX; o++) {
                if ((m >= o || !first) && (!TAIL || m < lim)) {
                    fa[o] = o ? __sad(e[o - 1], d[o - 1], fa[o]) : __sad(e[0], 0, fa[0]);
                    fn[o] += (uint32_t)e[o] >> 31;
                }
            }
        }
#pragma unroll
        for (int o = 0; o < NFIX - 1; o++) d[o] = e[o];
    }
}

// pass B's fixed residual of order O: sum(zigzag(d_O) >> k) at the thread's
// samples g >= O below n_valid (a sum that stays below 5 n_valid, see rice_k)
template <int O, bool TAIL>
__device__ __forceinline__ uint32_t fixed_rice_o(const int (&v)[HIST], int k, bool first, int lim) {
    int d[NFIX - 1] = {};
    uint32_t acc = 0;
    const int kk = k < 32 ? k : 31;
#pragma unroll
    for (int i = ORDER - O; i < HIST; i++) {
        int e = v[i];
#pragma unroll
        for (int o = 0; o < O; o++) {
            const int next = e - d[o];
            d[o] = e;
            e = next;
        }
        const int m = i - ORDER;
        if (m >= 0 && (m >= O || !first) && (!TAIL || m < lim))
            acc += (((uint32_t)e << 1) ^ (uint32_t)(e >> 31)) >> kk;
    }
    return k < 32 ? acc : 0;
}

template <bool TAIL>
__device__ __forceinline__ uint32_t fixed_rice(const int (&v)[HIST], int o, int k, bool first,
                                               int lim) {
    switch (o) {
        case 0: return fixed_rice_o<0, TAIL>(v, k, first, lim);
        case 1: return fixed_rice_o<1, TAIL>(v, k, first, lim);
        case 2: return fixed_rice_o<2, TAIL>(v, k, first, lim);
        case 3: return fixed_rice_o<3, TAIL>(v, k, first, lim);
        default: return fixed_rice_o<4, TAIL>(v, k, first, lim);
    }
}

// the zigzag LPC residual at the thread's sample m (slot ORDER + m), zero where
// the reference has none (g < ORDER, g >= n_valid). In general an IMAD.WIDE a
// tap and 64-bit arithmetic; SHORT (an int16 wire, shift >= 2) 32-bit: four
// taps of |q| <= 2^13 and |v| < 2^16 stay below 2^31, floor((p1 + p2) / 2) is
// (p1 >> 1) + (p2 >> 1) + (p1 & p2 & 1), and |pred >> shift| + |v| < 2^31
template <bool TAIL, bool SHORT>
__device__ __forceinline__ unsigned long long lpc_zigzag(const int (&v)[HIST],
                                                         const int (&q)[ORDER], int sh, bool first,
                                                         int lim, int m) {
    const int i = ORDER + m;
    unsigned long long z;
    if (SHORT) {
        int p1 = 0, p2 = 0;
#pragma unroll
        for (int j = 0; j < ORDER / 2; j++) {
            p1 += q[j] * v[i - 1 - j];
            p2 += q[ORDER / 2 + j] * v[i - 1 - ORDER / 2 - j];
        }
        const int r = v[i] - (((p1 >> 1) + (p2 >> 1) + (p1 & p2 & 1)) >> (sh - 1));
        z = ((uint32_t)r << 1) ^ (uint32_t)(r >> 31);
    } else {
        long long pred = 0;
#pragma unroll
        for (int j = 0; j < ORDER; j++) pred = mad_wide(q[j], v[i - 1 - j], pred);
        z = zigzag((long long)v[i] - (pred >> sh));
    }
    return (m >= ORDER || !first) && (!TAIL || m < lim) ? z : 0ull;
}

// pass B's LPC residuals: their zigzag total, each kept in u (low 32 bits; big
// where one needs more)
template <bool TAIL, bool SHORT>
__device__ __forceinline__ unsigned long long lpc_total(const int (&v)[HIST], const int (&q)[ORDER],
                                                        int sh, bool first, int lim,
                                                        uint32_t (&u)[SPT], bool& big) {
    unsigned long long tot = 0;
#pragma unroll
    for (int m = 0; m < SPT; m++) {
        const unsigned long long z = lpc_zigzag<TAIL, SHORT>(v, q, sh, first, lim, m);
        tot += z;
        if (!SHORT) big |= (z >> 32) != 0;
        u[m] = (uint32_t)z;
    }
    return tot;
}

template <typename T, bool TAIL>
__device__ __forceinline__ unsigned long long lpc_total(const int (&v)[HIST], const int (&q)[ORDER],
                                                        int sh, bool first, int lim,
                                                        uint32_t (&u)[SPT], bool& big) {
    if (sizeof(T) == 2 && sh >= 2) return lpc_total<TAIL, true>(v, q, sh, first, lim, u, big);
    return lpc_total<TAIL, false>(v, q, sh, first, lim, u, big);
}

// pass C predicting again: sum(u >> k) of the thread's LPC residuals
template <bool TAIL>
__device__ __forceinline__ uint32_t lpc_rice(const int (&v)[HIST], const int (&q)[ORDER], int sh,
                                             bool first, int lim, int k) {
    uint32_t acc = 0;
#pragma unroll
    for (int m = 0; m < SPT; m++) acc += (uint32_t)(lpc_zigzag<TAIL, false>(v, q, sh, first, lim, m) >> k);
    return acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, Occupancy<T>::blocks)
flac_analyze_kernel(const T* __restrict__ x, int rows, int N, int n_valid, int bits, int channels,
                    bool vec, int32_t* __restrict__ plans) {
    extern __shared__ __align__(16) unsigned char smem[];
    Shared& s = *reinterpret_cast<Shared*>(smem);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool mono = channels == 1;
    const int nc = mono ? 1 : NCAND;
    const int tiles = n_valid > TILE ? (n_valid + TILE - 1) / TILE : 1;

    if (tiles == 1) fill_window(s, tid, 0, n_valid);   // a thread reads only its own slots
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
        const T* xl = x + (size_t)row * 2 * N;
        const T* xr = xl + N;
        Wire<T> w;

        // ---- pass A: fixed sums and negatives, autocorrelation
        for (int tile = 0; tile < tiles; tile++) {
            const int tile0 = tile * TILE, g0 = tile0 + tid * SPT;
            const bool active = g0 < n_valid, first = g0 == 0;
            const int lim = n_valid - g0;
            if (tiles > 1) fill_window(s, tid, tile0, n_valid);
            w.load(xl, xr, g0, n_valid, vec, mono);
            for (int c = 0; c < nc; c++) {
                uint32_t fa[NFIX] = {}, fn[NFIX] = {};
                if (active) {
                    int v[HIST];
                    build<ORDER - 4, HIST>(w, c, v);
                    if (lim < SPT) fixed_sums<true>(v, first, lim, fa, fn);
                    else fixed_sums<false>(v, first, lim, fa, fn);
#pragma unroll
                    for (int k = 0; k < ORDER / 2; k++) {
                        const double2 ww = s.w[tid][sw8(tid, ORDER / 2 + k)];
                        const double2 xv = make_double2(
                            __dmul_rn(to_double(v[2 * ORDER + 2 * k]), ww.x),
                            __dmul_rn(to_double(v[2 * ORDER + 2 * k + 1]), ww.y));
                        s.line.xw[c & 1][tid][sw4(tid, k)] = xv;
                        if (tid == THREADS - 1) s.prev[(tile + 1) & 1][c][k] = xv;
                    }
                }
                unsigned long long ft[2 * NFIX];
#pragma unroll
                for (int o = 0; o < NFIX; o++) ft[o] = warp_total<T>(fa[o]);
                const unsigned n012 = __reduce_add_sync(FULL, fn[0] | fn[1] << 10 | fn[2] << 20);
                const unsigned n34 = __reduce_add_sync(FULL, fn[3] | fn[4] << 10);
                ft[NFIX] = n012 & 1023u, ft[NFIX + 1] = n012 >> 10 & 1023u;
                ft[NFIX + 2] = n012 >> 20, ft[NFIX + 3] = n34 & 1023u, ft[NFIX + 4] = n34 >> 10;
                if (lane == 0) {
#pragma unroll
                    for (int i = 0; i < 2 * NFIX; i++)
                        s.ired[c][warp][i] = (tile ? s.ired[c][warp][i] : 0ull) + ft[i];
                }
                __syncthreads();

                double dacc[NLAG];
#pragma unroll
                for (int lag = 0; lag < NLAG; lag++) dacc[lag] = 0.0;
                if (active) {
                    double xw[HIST];             // slots 0..7 the halo, 8..23 the thread's
#pragma unroll
                    for (int k = 0; k < ORDER / 2; k++) {
                        double2 h = make_double2(0.0, 0.0);
                        if (tid) h = s.line.xw[c & 1][tid - 1][sw4(tid - 1, k)];
                        else if (tile) h = s.prev[tile & 1][c][k];
                        xw[2 * k] = h.x, xw[2 * k + 1] = h.y;
                    }
                    int v[HIST];
                    build<ORDER, 2 * ORDER>(w, c, v);
#pragma unroll
                    for (int k = 0; k < ORDER / 2; k++) {
                        const double2 ww = s.w[tid][sw8(tid, k)];
                        xw[ORDER + 2 * k] = __dmul_rn(to_double(v[ORDER + 2 * k]), ww.x);
                        xw[ORDER + 2 * k + 1] = __dmul_rn(to_double(v[ORDER + 2 * k + 1]), ww.y);
                        const double2 own = s.line.xw[c & 1][tid][sw4(tid, k)];
                        xw[2 * ORDER + 2 * k] = own.x, xw[2 * ORDER + 2 * k + 1] = own.y;
                    }
#pragma unroll
                    for (int m = ORDER; m < HIST; m++) {
#pragma unroll
                        for (int lag = 0; lag < NLAG; lag++)
                            dacc[lag] = __dadd_rn(dacc[lag], __dmul_rn(xw[m - lag], xw[m]));
                    }
                }
                double sum;
                const int lag = warp_dsum9(dacc, lane, sum);
                if (lag < NLAG) s.dred[c][warp][lag] = sum;
            }
            __syncthreads();
            // the tile's sum: the warps in order, then onto the tiles before
            if (tid < nc) {
#pragma unroll
                for (int lag = 0; lag < NLAG; lag++) {
                    double sum = s.dred[tid][0][lag];
                    for (int wi = 1; wi < WARPS; wi++) sum = __dadd_rn(sum, s.dred[tid][wi][lag]);
                    s.ac[tid][lag] = __dadd_rn(tile ? s.ac[tid][lag] : 0.0, sum);
                }
            }
        }

        // ---- one thread a candidate: fixed order and its Rice parameter, Levinson, quantization
        if (tid < nc) {
            const int c = tid;
            unsigned long long fa[NFIX], fn[NFIX];
            for (int o = 0; o < NFIX; o++) {
                fa[o] = fn[o] = 0;
                for (int wi = 0; wi < WARPS; wi++) {
                    fa[o] += s.ired[c][wi][o];
                    fn[o] += s.ired[c][wi][NFIX + o];
                }
            }
            int o = 0;
            for (int oo = 1; oo < NFIX; oo++)
                if (fa[oo] < fa[o]) o = oo;
            s.fo[c] = o;
            s.fk[c] = rice_k(2 * fa[o] - fn[o], (long long)n_valid - o);

            const double* ac = s.ac[c];
            double a[ORDER];
            for (int j = 0; j < ORDER; j++) a[j] = 0.0;
            double err = ac[0];
            bool ok = err > 0;
            for (int i = 0; i < ORDER; i++) {
                double acc = ac[1];
                if (i) {
                    double sum = __dmul_rn(a[i - 1], ac[1]);
                    for (int j = 1; j < i; j++) sum = __dadd_rn(sum, __dmul_rn(a[i - 1 - j], ac[1 + j]));
                    acc = __dsub_rn(ac[i + 1], sum);
                }
                const double k = ok && err != 0.0 ? acc / err : 0.0;
                double na[ORDER];
                for (int j = 0; j < i; j++) na[j] = __dsub_rn(a[j], __dmul_rn(k, a[i - 1 - j]));
                for (int j = 0; j < i; j++) a[j] = na[j];
                a[i] = k;
                err = __dmul_rn(err, __dsub_rn(1.0, __dmul_rn(k, k)));
                ok = ok && err > 0;
            }
            // shift = clip(13 - floor(log2(max|a|)), 0, 15); a NaN max gives 13 and a
            // NaN coefficient 0 (the reference's float -> int conversion)
            double cmax = 0.0;
            bool nan = false;
            for (int j = 0; j < ORDER; j++) {
                nan |= isnan(a[j]);
                cmax = fmax(cmax, fabs(a[j]));
            }
            int shift = 12;                             // max|a| = 0: log2(1) + 1 = 1
            if (nan) shift = 13;
            else if (isinf(cmax)) shift = 0;
            else if (cmax > 0.0) shift = 12 - ilogb(cmax);
            shift = shift < 0 ? 0 : (shift > 15 ? 15 : shift);
            const double scale = (double)(1 << shift);
            const double lim = (double)(1 << (PRECISION - 1));
            bool any = false;
            for (int j = 0; j < ORDER; j++) {
                const double q = fmin(fmax(rint(__dmul_rn(a[j], scale)), -lim), lim - 1.0);
                const int qi = isnan(a[j]) ? 0 : (int)q;
                s.qlp[c][j] = qi;
                any |= qi != 0;
            }
            s.shift[c] = shift;
            s.ok[c] = ok && any && n_valid > 2 * ORDER;
        }
        __syncthreads();

        // ---- pass B: the chosen fixed residual's sum(u >> k), the LPC residuals'
        // zigzag total; pass C: their sum(u >> k), once the total gives k
        for (int c = 0; c < nc; c++) {
            const int o = s.fo[c], fk = s.fk[c], lpc = s.ok[c], sh = s.shift[c];
            int q[ORDER];
#pragma unroll
            for (int j = 0; j < ORDER; j++) q[j] = s.qlp[c][j];
            bool big = false;
            for (int tile = 0; tile < tiles; tile++) {
                const int g0 = tile * TILE + tid * SPT, lim = n_valid - g0;
                const bool first = g0 == 0;
                if (tiles > 1) w.load(xl, xr, g0, n_valid, vec, mono);
                uint32_t fsum = 0;
                unsigned long long ltot = 0;
                if (g0 < n_valid) {
                    int v[HIST];
                    build<0, HIST>(w, c, v);
                    fsum = lim < SPT ? fixed_rice<true>(v, o, fk, first, lim)
                                     : fixed_rice<false>(v, o, fk, first, lim);
                    if (lpc) {
                        uint32_t u[SPT];
                        ltot = lim < SPT ? lpc_total<T, true>(v, q, sh, first, lim, u, big)
                                         : lpc_total<T, false>(v, q, sh, first, lim, u, big);
                        if (tiles == 1) {
#pragma unroll
                            for (int k = 0; k < SPT / 4; k++)
                                s.line.u[c & 1][tid][sw4(tid, k)] =
                                    make_uint4(u[4 * k], u[4 * k + 1], u[4 * k + 2], u[4 * k + 3]);
                        }
                    }
                }
                const unsigned long long fw = __reduce_add_sync(FULL, fsum);
                const unsigned long long lw =
                    ((unsigned long long)__reduce_add_sync(FULL, (uint32_t)(ltot >> 20)) << 20) +
                    __reduce_add_sync(FULL, (uint32_t)ltot & 0xfffffu);
                if (lane == 0) {
                    s.bred[c][warp][0] = (tile ? s.bred[c][warp][0] : 0ull) + fw;
                    s.bred[c][warp][1] = (tile ? s.bred[c][warp][1] : 0ull) + lw;
                }
            }
            __syncthreads();
            if (!lpc) continue;
            unsigned long long tot = 0;
#pragma unroll
            for (int wi = 0; wi < WARPS; wi++) tot += s.bred[c][wi][1];
            const int lk = rice_k(tot, (long long)n_valid - ORDER);
            if (tid == 0) s.lk[c] = lk;
            for (int tile = 0; tile < tiles; tile++) {
                const int g0 = tile * TILE + tid * SPT, lim = n_valid - g0;
                const bool first = g0 == 0;
                uint32_t lsum = 0;
                if (g0 < n_valid) {
                    if (tiles == 1 && !big) {
                        const int kk = lk < 32 ? lk : 31;
#pragma unroll
                        for (int k = 0; k < SPT / 4; k++) {
                            const uint4 z = s.line.u[c & 1][tid][sw4(tid, k)];
                            lsum += (z.x >> kk) + (z.y >> kk) + (z.z >> kk) + (z.w >> kk);
                        }
                        if (lk >= 32) lsum = 0;
                    } else {
                        if (tiles > 1) w.load(xl, xr, g0, n_valid, vec, mono);
                        int v[HIST];
                        build<0, HIST>(w, c, v);
                        lsum = lim < SPT ? lpc_rice<true>(v, q, sh, first, lim, lk)
                                         : lpc_rice<false>(v, q, sh, first, lim, lk);
                    }
                }
                const unsigned cw = __reduce_add_sync(FULL, lsum);
                if (lane == 0) s.cred[c][warp] = (tile ? s.cred[c][warp] : 0u) + cw;
            }
        }
        __syncthreads();

        // ---- kind per candidate, then the assignment; the plan row
        if (tid == 0) {
            long long ccost[NCAND];
            int kind[NCAND];
            for (int c = 0; c < nc; c++) {
                const int o = s.fo[c];
                long long fsum = 0, lsum = 0;
                for (int wi = 0; wi < WARPS; wi++) {
                    fsum += (long long)s.bred[c][wi][0];
                    lsum += s.cred[c][wi];
                }
                const long long fcost = fsum + ((long long)n_valid - o) * (1 + s.fk[c]) +
                                        (long long)o * bits + 8 + 6;
                const long long lcost = s.ok[c]
                    ? lsum + ((long long)n_valid - ORDER) * (1 + s.lk[c]) +
                          (long long)ORDER * bits + 8 + 6 + 4 + 5 + ORDER * PRECISION
                    : NO_LPC;
                kind[c] = lcost < fcost;
                ccost[c] = lcost < fcost ? lcost : fcost;
            }
            const int codes[4] = {1, 8, 9, 10};
            const int slot[4][2] = {{0, 1}, {0, 2}, {2, 1}, {3, 2}};
            int best = 0, assign = 0;
            if (!mono) {
                long long bc = ccost[0] + ccost[1];
                for (int b = 1; b < 4; b++) {
                    const long long cb = ccost[slot[b][0]] + ccost[slot[b][1]];
                    if (cb < bc) { bc = cb; best = b; }
                }
                assign = codes[best];
            }
            int32_t* out = plans + (size_t)row * PLAN;
            out[0] = assign;
            for (int sl = 0; sl < 2; sl++) {
                const int c = mono ? 0 : slot[best][sl];
                out[1 + sl] = kind[c];
                out[3 + sl] = kind[c] ? ORDER : s.fo[c];
                out[5 + sl] = s.shift[c];
                for (int j = 0; j < ORDER; j++) out[7 + sl * ORDER + j] = s.qlp[c][j];
            }
        }
    }
}

// the dynamic shared memory attribute, then the SMs x resident blocks a
// persistent grid fills (found once an instance)
template <typename T>
cudaError_t prepare(int* grid_cap) {
    static int cap = 0;
    if (!cap) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaError_t e = cudaFuncSetAttribute(flac_analyze_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             sizeof(Shared));
        if (e == cudaSuccess) e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flac_analyze_kernel<T>,
                                                              THREADS, sizeof(Shared));
        if (e != cudaSuccess) return e;
        if (per_sm < 1) return cudaErrorLaunchOutOfResources;
        cap = sms * per_sm;
    }
    *grid_cap = cap;
    return cudaSuccess;
}

template <typename T>
int launch(const T* x, int rows, int n, int n_valid, int bits, int channels, int32_t* plans,
           cudaStream_t stream) {
    int cap = 0;
    const cudaError_t e = prepare<T>(&cap);
    if (e != cudaSuccess) return (int)e;
    // 16-byte loads need every row and channel on a 16-byte boundary
    const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && n % (16 / (int)sizeof(T)) == 0;
    flac_analyze_kernel<T><<<rows < cap ? rows : cap, THREADS, sizeof(Shared), stream>>>(
        x, rows, n, n_valid, bits, channels, vec, plans);
    return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int* out) {
    int cap = 0;
    cudaError_t e = prepare<T>(&cap);
    cudaFuncAttributes a;
    int per_sm = 0;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, flac_analyze_kernel<T>);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flac_analyze_kernel<T>,
                                                          THREADS, sizeof(Shared));
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)sizeof(Shared);
    out[3] = per_sm;
    out[4] = cap;
    return 0;
}

}  // namespace

extern "C" int skt_flac_analyze(const void* x, int wide, int rows, int n, int n_valid, int bits,
                                int channels, int32_t* plans, void* stream) {
    if (rows <= 0) return 0;
    if (n <= 0 || n_valid < 0 || n_valid > n || (channels != 1 && channels != 2))
        return (int)cudaErrorInvalidValue;
    return wide ? launch((const int32_t*)x, rows, n, n_valid, bits, channels, plans,
                         (cudaStream_t)stream)
                : launch((const int16_t*)x, rows, n, n_valid, bits, channels, plans,
                         (cudaStream_t)stream);
}

// K14's build as the card runs it, for the int16 (wide = 0) or int32 wire:
// out[0] registers a thread, out[1] local (spilled) bytes a thread, out[2]
// dynamic shared bytes a block, out[3] resident blocks an SM, out[4] the
// persistent grid
extern "C" int skt_flac_analyze_occupancy(int wide, int* out) {
    return wide ? occupancy<int32_t>(out) : occupancy<int16_t>(out);
}
