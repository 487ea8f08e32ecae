// K12: the SILK LTP/LPC synthesis of one 20 ms frame for every (lane, channel)
// row (synth_frame of soundkit_tpu/ops/silk_batch.py, its lax.scan at :229): one
// launch a silk_round.
//
// A row carries its output line dst = out_hist (322) ++ the frame (4 x sfl) and
// its residual line res = the 290 positions before the frame ++ the frame's
// excitation. The reference runs, for each subframe i in order: (b) on a voiced
// row, the re-whitening: an order-`order` FIR of dst, clipped, times rescale /
// g_i, replaces the residual on [-lag - 2, out_end), and for i > 0 the residual
// on [out_end, 0) is scaled by g_{i-1} / g_i; (c1) the 5-tap LTP r_j = e_j +
// sum_k ltp[k] res[j - lag + 2 - k] (voiced rows), written back into the
// residual; (c2) the LPC u_j = r_j g_i + sum_k coeff[k] u_{j-1-k}, clip(u_j) into
// dst, the unclipped u_j into the carried tail.
//
// The data flow lets (b) and (c1) run ahead of the LPC. A subframe's re-whitened
// span ends at the frame start (out_end = -i sfl) but on a lead-in frame's
// subframes 2-3, so its FIR reads only out_hist; the LTP reads only the residual
// line. So (b) and (c1) of subframe i + 1 run while the LPC runs over subframe i,
// each r_j g_i kept in the frame's part of dst (which the LPC then reads and
// overwrites with clip(u_j)) before the next subframe's rescale changes r_j. On a
// voiced lead-in row the re-whitening of subframes 2-3 reads the output of
// subframes 0-1, so it waits for the LPC to finish subframe 1. The subframes
// that share a coefficient set and read the same fixed output (all four; or 0-1
// and 2-3 on a lead-in row) have one FIR value v(p) a position, so the FIR runs
// once over the union of their spans and each subframe writes v(p) rescale / g_i
// over its own. Every value keeps the plain version's arithmetic
// (ops/silk_synth.py): each product and sum rounded alone (__fmul_rn, __fadd_rn,
// __fdiv_rn) in its order, the FIR and the LTP over k ascending from 0, the LPC
// as (r_j g_i + T) + coeff[0] u_{j-1} with T the pairwise sum of coeff[k]
// u_{j-1-k}, k from order - 1 down to 1. So the bits are the plain version's.
//
// Layout: warp-specialized pairs. An LPC warp owns R = 8 rows, one a lane; a
// loader warp brings the rows' history and parameters and works out each (row,
// subframe)'s ratios and ranges once, a lane each, and then writes the output out
// as the LPC finishes each subframe; four stage warps, two rows each, run (b) and
// (c1) a subframe ahead of the LPC. A block is two pairs of six warps, so a WB
// round of 1024 x 2 rows is 128 blocks and 256 LPC warps, about one a scheduler.
// (A block of eight warps a pair with two left empty, so that warp w's scheduler,
// w % 4 as the card appears to assign it, held an LPC warp and its loader alone,
// kept the bits and was slower: PERF.md section 6.) The warps of a pair
// meet at mbarriers in shared memory: the loads and plans done (P), subframe i's
// r_j g_i ready (R[i]) and subframe i's output written (D[i]); no block barrier
// follows the mbarriers' set-up. A stage warp runs the FIR over each voiced row's
// span only (all 32 lanes a row, no idle iterations over unvoiced rows), writes
// the spans and rescales what a later subframe still reads, and runs the LTP with
// 16 lanes a row, 2 samples a lane, in steps of min(32, lag - 2) samples (every
// read of a step lies before it). The LPC warp also forms every row's excitation
// times the gain as it loads it (an unvoiced row's r_j g_i; a voiced row's stage
// rewrites its own). The LPC lane keeps its row's 16-sample tail in registers and
// runs in chunks of 16 samples, over which the tail renames itself, r_j g_i
// coming in and clip(u_j) going out 16 bytes at a time; T for the next sample
// needs only u_{j-1} and older, so the compiler interleaves it with the current
// sample's c0 u_{j-1} chain. Lags are clamped to [3, 288] on both paths (valid
// streams: 16..288), so no read leaves the lines; rows past the end read as zeros
// and store nothing.
//
// Bound on the card: the LPC's issue. The bytes are ~5.5 KB a row in and out
// (~3.4 us for the WB round); the LPC is a serial recursion of 4 sfl samples a
// row at ~2 order + 3 instructions a sample that a warp issues at most one a
// clock, whatever rows its lanes hold (~6.5 us at WB). Hence an LPC warp for
// every scheduler from the first subframe on, everything else beside it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB = 4;           // subframes a 20 ms frame
constexpr int LTP_ORDER = 5;
constexpr int HIST = 322;        // carried output history
constexpr int MAXLAG = 290;      // residual line before the frame
constexpr int EXC = 320;         // the excitation row's stride
constexpr int TAIL = 16;         // the carried LPC tail
constexpr int LAG_MIN = 3, LAG_MAX = 288;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int R = 8;             // rows a pair: an LPC lane each
constexpr int PAIRS = 2;         // pairs a block
constexpr int STAGES = 4;        // stage warps a pair, R / STAGES rows each
constexpr int SR = R / STAGES;   // rows a stage warp
// a block's warps, warp w in pair w % PAIRS and slot w / PAIRS: the LPC warp
// (slot 0), the loader (slot 1) and the stage warps (slots 2-5)
constexpr int SLOTS = 2 + STAGES;
constexpr int THREADS = WARP * PAIRS * SLOTS;
constexpr int LPR = WARP / SR;   // lanes a row in the LTP
constexpr int LTP_SAMPLES = WARP / LPR;  // samples a lane a LTP step: LPR x this = 32
constexpr int DOFF = 2, ROFF = 2;        // line pads: the frame starts 16-byte aligned
constexpr int VLEN = MAXLAG + 2;         // a group's FIR values (its span is <= 290)
constexpr int BATCH = 4;                 // shared-memory reads a lane batches before its stores
// mbarriers of a pair: the loads and plans in (P), subframe i's r_j g_i ready
// (R[i]), subframe i's output written (D[i]; D[1] is also what the stage waits
// for before a lead-in row's subframes 2-3)
enum { BAR_P, BAR_R0, BAR_D0 = BAR_R0 + SUB, NBAR = BAR_D0 + SUB };

template <int BW> struct Geo;
template <> struct Geo<0> { static constexpr int SFL = 40, ORDER = 10; };  // NB
template <> struct Geo<1> { static constexpr int SFL = 60, ORDER = 10; };  // MB
template <> struct Geo<2> { static constexpr int SFL = 80, ORDER = 16; };  // WB

// one pair's rows; every member a multiple of 16 bytes
template <int SFL> struct alignas(16) PairSmem {
    float dst[R][DOFF + HIST + SUB * SFL];   // frame at DOFF + HIST: r g, then clip(u)
    float res[R][ROFF + MAXLAG + SUB * SFL]; // frame at ROFF + MAXLAG
    float v[R][VLEN];                        // the group's FIR values, from its lo
    float gains[R][SUB];
    float ltp[R][SUB][LTP_ORDER];
    float coef[R][2][TAIL];
    float ltpscale[R];
    int lags[R][SUB];
    int voiced[R];
    int lead[R];
    // a (row, subframe) plan, a lane each: rescale / g_i, g_{i-1} / g_i, the span's
    // start, where its gain-ratio range starts, its group's lo, the LTP's step
    // width and steps
    float ps[R][SUB], pq[R][SUB];
    int plo[R][SUB], prs[R][SUB], pglo[R][SUB], pstep[R][SUB], pn[R][SUB];
    unsigned long long bar[NBAR];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(unsigned long long* b, unsigned count) {
    asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_addr(b)), "r"(count) : "memory");
}
// every lane arrives (release: its shared-memory writes before it)
__device__ __forceinline__ void bar_arrive(unsigned long long* b) {
    unsigned long long state;
    asm volatile("mbarrier.arrive.shared.b64 %0, [%1];" : "=l"(state) : "r"(smem_addr(b)) : "memory");
}
// wait for the barrier's first phase (acquire); a warp that shares its
// scheduler with an LPC warp (the loader) sleeps between its tries
template <bool SLEEP = false>
__device__ __forceinline__ void bar_wait(unsigned long long* b) {
    uint32_t done = 0;
    for (;;) {
        asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared.b64 p, [%1], 0; "
                     "selp.u32 %0, 1, 0, p; }"
                     : "=r"(done) : "r"(smem_addr(b)) : "memory");
        if (done) break;
        if (SLEEP) __nanosleep(256);
    }
}

// clip to [-1, 1] as jnp.clip / torch.clamp do: a NaN passes through
__device__ __forceinline__ float clip1(float v) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(1.f));
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(r), "f"(-1.f));
    return r;
}

__device__ __forceinline__ int clamp_lag(int lag) {
    return lag < LAG_MIN ? LAG_MIN : (lag > LAG_MAX ? LAG_MAX : lag);
}

// a row's subframe i belongs to group 1 on a lead-in frame's subframes 2-3 (its
// FIR reads the frame's output up to 2 sfl), else to group 0 (reads out_hist)
__device__ __forceinline__ int group_of(bool lead, int i) { return (lead && i >= 2) ? 1 : 0; }

// the (row, subframe) plan of lane 4 r + i: r's subframe i's span [lo_i, hi)
// (lo_i = i sfl - lag - 2) takes v(p) rescale / g_i, and its gain-ratio range
// [hi, i sfl) is scaled by g_{i-1} / g_i from the lowest position a subframe
// i' >= i still reads (max(lo_i', hi_i')): below it the residual is read no more
template <int BW>
__device__ __forceinline__ void make_plan(PairSmem<Geo<BW>::SFL>& sm, int lane, float g, int lag_in,
                                          float ltpscale, bool lead) {
    constexpr int SFL = Geo<BW>::SFL;
    static_assert(R * SUB == WARP, "a (row, subframe) a lane");
    const int r = lane / SUB, i = lane % SUB;
    const float gprev = __shfl_up_sync(FULL, g, 1);  // g_{i-1}: the lane before, same row
    const int gr = group_of(lead, i), hi = gr ? 2 * SFL : 0;
    const int lag = clamp_lag(lag_in);
    const int lo = i * SFL - lag - LTP_ORDER / 2;
    // the group's lo: the least lo over the row's subframes of the same group
    int glo = lo;
#pragma unroll
    for (int d = 1; d < SUB; d <<= 1) {
        const int o = __shfl_xor_sync(FULL, glo, d);
        const int og = __shfl_xor_sync(FULL, gr, d);
        if (og == gr) glo = min(glo, o);
    }
    // the least max(lo_i', hi_i') over i' >= i
    int rd = max(lo, hi);
#pragma unroll
    for (int d = 1; d < SUB; d <<= 1) {
        const int o = __shfl_down_sync(FULL, rd, d);
        if (i + d < SUB) rd = min(rd, o);
    }
    const int S = min(WARP, lag - 2);
    sm.ps[r][i] = __fdiv_rn(gr ? 1.f : ltpscale, g);
    sm.pq[r][i] = i > 0 ? __fdiv_rn(gprev, g) : 0.f;
    sm.plo[r][i] = lo;
    sm.prs[r][i] = max(hi, rd);
    sm.pglo[r][i] = glo;
    sm.pstep[r][i] = S;
    sm.pn[r][i] = (SFL + S - 1) / S;
}

// the FIR once over the span [lo, hi) of group gr of each row in `rows` (a bit
// a row), 32 lanes a row
template <int BW>
__device__ __forceinline__ void fir(PairSmem<Geo<BW>::SFL>& sm, unsigned rows, int gr, int lane) {
    constexpr int SFL = Geo<BW>::SFL, ORDER = Geo<BW>::ORDER;
    const int hi = gr ? 2 * SFL : 0;
#pragma unroll 1
    for (; rows; rows &= rows - 1) {
        const int r = __ffs(rows) - 1;
        const int lo = sm.pglo[r][gr ? 2 : 0];
        const float* cs = sm.coef[r][(gr == 0 && sm.lead[r]) ? 0 : 1];
        float c[ORDER];
#pragma unroll
        for (int k = 0; k < ORDER; ++k) c[k] = cs[k];
        const float* d = sm.dst[r] + DOFF + HIST;
        float* v = sm.v[r] - lo;
#pragma unroll 1
        for (int p0 = lo + lane; p0 < hi; p0 += BATCH * WARP) {
            float acc[BATCH], dp[BATCH];  // a batch's reads before its stores
#pragma unroll
            for (int m = 0; m < BATCH; ++m) {
                const int p = min(p0 + WARP * m, hi - 1);
                acc[m] = 0.f;
#pragma unroll
                for (int k = 0; k < ORDER; ++k)
                    acc[m] = __fadd_rn(acc[m], __fmul_rn(d[p - 1 - k], c[k]));
                dp[m] = d[p];
            }
#pragma unroll
            for (int m = 0; m < BATCH; ++m)
                if (p0 + WARP * m < hi) v[p0 + WARP * m] = clip1(__fsub_rn(dp[m], acc[m]));
        }
    }
}

// (b) and (c1) of subframe i for each voiced row in `rows` (rows rb .. rb + SR)
template <int BW>
__device__ __forceinline__ void subframe(PairSmem<Geo<BW>::SFL>& sm, unsigned rows, int i,
                                         int rb, int lane) {
    constexpr int SFL = Geo<BW>::SFL;
    // the span [lo_i, hi) takes v(p) rescale / g_i; [rs, i sfl) is scaled by
    // g_{i-1} / g_i (rs >= hi)
#pragma unroll 1
    for (unsigned w = rows; w; w &= w - 1) {
        const int r = __ffs(w) - 1;
        const int hi = group_of(sm.lead[r] != 0, i) ? 2 * SFL : 0;
        const float s = sm.ps[r][i], q = sm.pq[r][i];
        const int a = min(sm.plo[r][i], hi), b = sm.prs[r][i];
        const int n1 = hi - a, n = n1 + i * SFL - b;
        const float* v = sm.v[r] - sm.pglo[r][i];
        float* res = sm.res[r] + ROFF + MAXLAG;
#pragma unroll 1
        for (int k0 = lane; k0 < n; k0 += BATCH * WARP) {
            float nv[BATCH];  // a batch's reads before its stores
#pragma unroll
            for (int m = 0; m < BATCH; ++m) {
                const int k = min(k0 + WARP * m, n - 1), p = k < n1 ? a + k : b + k - n1;
                nv[m] = k < n1 ? __fmul_rn(v[p], s) : __fmul_rn(res[p], q);
            }
#pragma unroll
            for (int m = 0; m < BATCH; ++m) {
                const int k = k0 + WARP * m;
                if (k < n) res[k < n1 ? a + k : b + k - n1] = nv[m];
            }
        }
    }
    __syncwarp();

    // the LTP: LPR lanes a row, LTP_SAMPLES samples a lane, steps of S samples
    int steps = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
        if ((rows >> r) & 1) steps = max(steps, sm.pn[r][i]);
    const int rr = rb + lane / LPR, sl = lane % LPR;
    const int lag = clamp_lag(sm.lags[rr][i]);
    const int S = sm.pstep[rr][i];
    const int nsteps = (rows >> rr) & 1 ? sm.pn[rr][i] : 0;
    float tp[LTP_ORDER];
#pragma unroll
    for (int k = 0; k < LTP_ORDER; ++k) tp[k] = sm.ltp[rr][i][k];
    const float g = sm.gains[rr][i];
    float* res = sm.res[rr] + ROFF + MAXLAG + i * SFL;
    float* rg = sm.dst[rr] + DOFF + HIST + i * SFL;
#pragma unroll 1
    for (int st = 0; st < steps; ++st) {
        if (st < nsteps) {
            float ev[LTP_SAMPLES], acc[LTP_SAMPLES];
            // every read of the step first: they all lie before it
#pragma unroll
            for (int m = 0; m < LTP_SAMPLES; ++m) {
                const int j = min(st * S + min(sl + LPR * m, S - 1), SFL - 1);
                const float* past = res + j - lag + LTP_ORDER / 2;
                acc[m] = 0.f;
#pragma unroll
                for (int k = 0; k < LTP_ORDER; ++k)
                    acc[m] = __fadd_rn(acc[m], __fmul_rn(tp[k], past[-k]));
                ev[m] = res[j];
            }
#pragma unroll
            for (int m = 0; m < LTP_SAMPLES; ++m) {
                const int jj = sl + LPR * m, j = st * S + jj;
                if (jj < S && j < SFL) {
                    const float rj = __fadd_rn(ev[m], acc[m]);
                    res[j] = rj;
                    rg[j] = __fmul_rn(rj, g);
                }
            }
        }
        __syncwarp();
    }
}

// the pairwise sum of t[0 .. N): neighbours added level by level, an odd
// last term passed up, t[0] + t[1] first (the plain version's order)
template <int N, int M>
__device__ __forceinline__ float tree_sum(float (&t)[M]) {
    if constexpr (N == 1) {
        return t[0];
    } else {
        constexpr int H = N / 2;
#pragma unroll
        for (int i = 0; i < H; ++i) t[i] = __fadd_rn(t[2 * i], t[2 * i + 1]);
        if constexpr (N % 2 == 1) t[H] = t[N - 1];
        return tree_sum<(N + 1) / 2>(t);
    }
}

// LEN samples of the LPC from io (r_j g_i in, clip(u_j) out), tail[k] = u_{j-1-k}:
// u_j = (r_j g + tree(coeff[k] u_{j-1-k}, k = order-1 .. 1)) + coeff[0] u_{j-1}
template <int ORDER, int LEN>
__device__ __forceinline__ void lpc_chunk(float (&tail)[TAIL], const float (&c)[ORDER],
                                          float* __restrict__ io) {
    float rg[LEN];
#pragma unroll
    for (int q = 0; q < LEN / 4; ++q) {
        const float4 x = reinterpret_cast<const float4*>(io)[q];
        rg[4 * q] = x.x, rg[4 * q + 1] = x.y, rg[4 * q + 2] = x.z, rg[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int q = 0; q < LEN / 4; ++q) {
        float out[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            float t[ORDER - 1];
#pragma unroll
            for (int k = ORDER - 1; k >= 1; --k) t[ORDER - 1 - k] = __fmul_rn(c[k], tail[k]);
            const float u = __fadd_rn(__fadd_rn(rg[4 * q + m], tree_sum<ORDER - 1>(t)),
                                      __fmul_rn(c[0], tail[0]));
#pragma unroll
            for (int k = TAIL - 1; k > 0; --k) tail[k] = tail[k - 1];
            tail[0] = u;
            out[m] = clip1(u);
        }
        reinterpret_cast<float4*>(io)[q] = make_float4(out[0], out[1], out[2], out[3]);
    }
}

// n samples (a multiple of 4) of the LPC: chunks of 16, over which the tail
// renames itself, then one of 8 and one of 4 where n needs them
template <int ORDER>
__device__ __forceinline__ void lpc_run(float (&tail)[TAIL], const float (&c)[ORDER], float* io,
                                        int n) {
#pragma unroll 1
    for (int j0 = 0; j0 + 16 <= n; j0 += 16) lpc_chunk<ORDER, 16>(tail, c, io + j0);
    if (n & 8) lpc_chunk<ORDER, 8>(tail, c, io + (n & ~15));
    if (n & 4) lpc_chunk<ORDER, 4>(tail, c, io + (n & ~7));
}

// the loader of a pair: the rows' parameters and history, rows past the end as
// zeros (every load of a lane in flight before its first store), the rows'
// plans worked out while the history is on its way; once the pair has them (P),
// the history into the output's first HIST samples, unchanged, and then each
// subframe's output as the LPC writes it (D[i])
template <int BW>
__device__ __forceinline__ void loader_warp(PairSmem<Geo<BW>::SFL>& sm, int row0, int nr, int lane,
                                            const float* __restrict__ gains,
                                            const int* __restrict__ has_leadin,
                                            const int* __restrict__ voiced,
                                            const int* __restrict__ lags,
                                            const float* __restrict__ ltp,
                                            const float* __restrict__ ltpscale,
                                            const float* __restrict__ out_hist,
                                            float* __restrict__ dst) {
    constexpr int SFL = Geo<BW>::SFL, FLEN = SUB * SFL, DLEN = HIST + FLEN;
    constexpr int NH = (R * HIST + WARP - 1) / WARP / 2 + 1;  // history loads a lane, a half
    constexpr int NL = (R * SUB * LTP_ORDER + WARP - 1) / WARP;
    static_assert(R * SUB == WARP, "a gain and a lag a lane");
    static_assert(2 * NH * WARP >= R * HIST, "");
    float gv = 0.f, sv = 0.f, lv[NL], hv[NH];
    int lg = 0, vo = 0, ld = 0;
    if (lane < nr * SUB) {
        gv = gains[(size_t)row0 * SUB + lane];
        lg = lags[(size_t)row0 * SUB + lane];
    }
    if (lane < nr) {
        sv = ltpscale[row0 + lane];
        vo = voiced[row0 + lane];
        ld = has_leadin[row0 + lane];
    }
#pragma unroll
    for (int q = 0; q < NL; ++q) {
        const int e = lane + WARP * q;
        lv[q] = e < nr * SUB * LTP_ORDER ? ltp[(size_t)row0 * SUB * LTP_ORDER + e] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < NH; ++q) {
        const int e = lane + WARP * q;
        hv[q] = e < nr * HIST ? out_hist[(size_t)row0 * HIST + e] : 0.f;
    }
    const int r = lane / SUB;
    make_plan<BW>(sm, lane, gv, lg, __shfl_sync(FULL, sv, r), __shfl_sync(FULL, ld, r) != 0);
    (&sm.gains[0][0])[lane] = gv;
    (&sm.lags[0][0])[lane] = lg;
    if (lane < R) {
        sm.ltpscale[lane] = sv;
        sm.voiced[lane] = vo;
        sm.lead[lane] = ld;
    }
#pragma unroll
    for (int q = 0; q < NL; ++q)
        if (lane + WARP * q < R * SUB * LTP_ORDER) (&sm.ltp[0][0][0])[lane + WARP * q] = lv[q];
    // the history in two halves of NH loads a lane
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
        if (half) {
#pragma unroll
            for (int q = 0; q < NH; ++q) {
                const int e = lane + WARP * (NH + q);
                hv[q] = e < nr * HIST ? out_hist[(size_t)row0 * HIST + e] : 0.f;
            }
        }
#pragma unroll
        for (int q = 0; q < NH; ++q) {
            const int e = lane + WARP * (half * NH + q), rr = e / HIST;
            if (e < R * HIST) sm.dst[rr][DOFF + e - rr * HIST] = hv[q];
        }
    }
    bar_arrive(&sm.bar[BAR_P]);
    // the history, unchanged, into the output's first HIST samples
#pragma unroll 4
    for (int e = lane; e < nr * HIST; e += WARP) {
        const int rr = e / HIST;
        dst[(size_t)(row0 + rr) * DLEN + e - rr * HIST] = sm.dst[rr][DOFF + e - rr * HIST];
    }
#pragma unroll 1
    for (int i = 0; i < SUB; ++i) {
        bar_wait<true>(&sm.bar[BAR_D0 + i]);
#pragma unroll 4
        for (int e = lane; e < nr * SFL; e += WARP) {
            const int rr = e / SFL, j = i * SFL + e - rr * SFL;
            dst[(size_t)(row0 + rr) * DLEN + HIST + j] = sm.dst[rr][DOFF + HIST + j];
        }
    }
}

// a stage warp of a pair: (b) and (c1) of rows rb .. rb + SR a subframe ahead of
// the LPC
template <int BW>
__device__ __forceinline__ void stage_warp(PairSmem<Geo<BW>::SFL>& sm, int rb, int lane) {
    bar_wait(&sm.bar[BAR_P]);  // the loads and the plans
    unsigned vrows = 0, lrows = 0;  // voiced rows; voiced rows with a lead-in
#pragma unroll
    for (int r = rb; r < rb + SR; ++r) {
        if (sm.voiced[r]) vrows |= 1u << r;
        if (sm.voiced[r] && sm.lead[r]) lrows |= 1u << r;
    }
    __syncwarp();
    fir<BW>(sm, vrows, 0, lane);
    __syncwarp();
#pragma unroll 1
    for (int i = 0; i < SUB; ++i) {
        if (i == 2 && lrows) {
            subframe<BW>(sm, vrows & ~lrows, 2, rb, lane);
            bar_wait(&sm.bar[BAR_D0 + 1]);  // subframes 0-1's output, which group 1's FIR reads
            fir<BW>(sm, lrows, 1, lane);
            __syncwarp();
            subframe<BW>(sm, lrows, 2, rb, lane);
        } else {
            subframe<BW>(sm, vrows, i, rb, lane);
        }
        bar_arrive(&sm.bar[BAR_R0 + i]);
    }
}

template <int BW>
__global__ void __launch_bounds__(THREADS)
silk_synth_kernel(const float* __restrict__ exc, const float* __restrict__ gains,
                  const float* __restrict__ coef, const int* __restrict__ has_leadin,
                  const int* __restrict__ voiced, const int* __restrict__ lags,
                  const float* __restrict__ ltp, const float* __restrict__ ltpscale,
                  const float* __restrict__ out_hist, const float* __restrict__ lpch_tail,
                  float* __restrict__ dst, float* __restrict__ new_tail, int rows) {
    constexpr int SFL = Geo<BW>::SFL, ORDER = Geo<BW>::ORDER, FLEN = SUB * SFL, DLEN = HIST + FLEN;
    extern __shared__ float4 smem_raw[];  // dynamic: above the 48 KB of static shared memory
    const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP, pair = w % PAIRS;
    const int slot = w / PAIRS;
    PairSmem<SFL>& sm = reinterpret_cast<PairSmem<SFL>*>(smem_raw)[pair];
    if (slot == 0 && lane < NBAR)  // P: the LPC warp and the loader; R[i]: the stage warps
        bar_init(&sm.bar[lane], lane == BAR_P ? 2 * WARP : (lane < BAR_D0 ? STAGES * WARP : WARP));
    __syncthreads();  // the block's only barrier: the mbarriers set up
    const int row0 = (blockIdx.x * PAIRS + pair) * R;
    if (row0 >= rows) return;  // the whole pair
    const int nr = min(R, rows - row0);
    if (slot == 1) {
        loader_warp<BW>(sm, row0, nr, lane, gains, has_leadin, voiced, lags, ltp, ltpscale,
                        out_hist, dst);
        return;
    }
    if (slot != 0) {
        stage_warp<BW>(sm, (slot - 2) * SR, lane);
        return;
    }

    // the LPC warp: the excitation into the residual line and, times the gain, as
    // r_j g_i into the frame's part of the output line (a voiced row's stage
    // rewrites it); its row's tail, coefficients and lead-in flag into registers
    float tail[TAIL];
    bool lead = false;
    {
        constexpr int NE = R * FLEN / WARP / 2;  // excitation loads a lane, a half
        static_assert(2 * NE * WARP == R * FLEN, "");
        float ev[NE];
        const float gv = lane < nr * SUB ? gains[(size_t)row0 * SUB + lane] : 0.f;
#pragma unroll
        for (int q = 0; q < NE; ++q) {
            const int e = lane + WARP * q, r = e / FLEN;
            ev[q] = e < nr * FLEN ? exc[(size_t)(row0 + r) * EXC + e - r * FLEN] : 0.f;
        }
        const bool in = lane < nr;
        const size_t row = (size_t)row0 + (in ? lane : 0);
#pragma unroll
        for (int k = 0; k < TAIL; ++k) tail[k] = in ? lpch_tail[row * TAIL + k] : 0.f;
        float cv[2 * TAIL * R / WARP];  // the pair's coefficient sets, coalesced
#pragma unroll
        for (int q = 0; q < 2 * TAIL * R / WARP; ++q) {
            const int e = lane + WARP * q;
            cv[q] = e < nr * 2 * TAIL ? coef[(size_t)row0 * 2 * TAIL + e] : 0.f;
        }
        lead = in && has_leadin[row] != 0;
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
            if (half) {
#pragma unroll
                for (int q = 0; q < NE; ++q) {
                    const int e = lane + WARP * (NE + q), r = e / FLEN;
                    ev[q] = e < nr * FLEN ? exc[(size_t)(row0 + r) * EXC + e - r * FLEN] : 0.f;
                }
            }
#pragma unroll
            for (int q = 0; q < NE; ++q) {
                const int e = lane + WARP * (half * NE + q), r = e / FLEN, j = e - r * FLEN;
                const float g = __shfl_sync(FULL, gv, r * SUB + j / SFL);
                sm.res[r][ROFF + MAXLAG + j] = ev[q];
                sm.dst[r][DOFF + HIST + j] = __fmul_rn(ev[q], g);
            }
        }
#pragma unroll
        for (int q = 0; q < 2 * TAIL * R / WARP; ++q) (&sm.coef[0][0][0])[lane + WARP * q] = cv[q];
    }
    bar_arrive(&sm.bar[BAR_P]);
    float* io = sm.dst[lane % R] + DOFF + HIST;
#pragma unroll 1
    for (int i = 0; i < SUB; ++i) {
        bar_wait(&sm.bar[BAR_R0 + i]);
        if (lane < R) {
            const float* cs = sm.coef[lane][(lead && i < 2) ? 0 : 1];
            float c[ORDER];
#pragma unroll
            for (int k = 0; k < ORDER; ++k) c[k] = cs[k];
            lpc_run<ORDER>(tail, c, io + i * SFL, SFL);
        }
        bar_arrive(&sm.bar[BAR_D0 + i]);  // the loader stores it
    }
    if (lane < nr) {
#pragma unroll
        for (int k = 0; k < TAIL; ++k) new_tail[(size_t)(row0 + lane) * TAIL + k] = tail[k];
    }
}

template <int BW>
cudaError_t launch(const float* exc, const float* gains, const float* coef, const int* has_leadin,
                   const int* voiced, const int* lags, const float* ltp, const float* ltpscale,
                   const float* out_hist, const float* lpch_tail, float* dst, float* new_tail,
                   int rows, cudaStream_t s) {
    constexpr size_t SMEM = PAIRS * sizeof(PairSmem<Geo<BW>::SFL>);
    static const cudaError_t attr = cudaFuncSetAttribute(
        silk_synth_kernel<BW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (attr != cudaSuccess) return attr;
    constexpr int ROWS = R * PAIRS;
    const unsigned grid = (unsigned)((rows + ROWS - 1) / ROWS);
    silk_synth_kernel<BW><<<grid, THREADS, SMEM, s>>>(exc, gains, coef, has_leadin, voiced, lags,
                                                      ltp, ltpscale, out_hist, lpch_tail, dst,
                                                      new_tail, rows);
    return cudaGetLastError();
}

}  // namespace

extern "C" int skt_silk_synth(const float* exc, const float* gains, const float* coef,
                              const int* has_leadin, const int* voiced, const int* lags,
                              const float* ltp, const float* ltpscale, const float* out_hist,
                              const float* lpch_tail, float* dst, float* new_tail, int rows,
                              int bw, void* stream) {
    if (rows <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (bw == 0)
        return (int)launch<0>(exc, gains, coef, has_leadin, voiced, lags, ltp, ltpscale, out_hist,
                              lpch_tail, dst, new_tail, rows, s);
    if (bw == 1)
        return (int)launch<1>(exc, gains, coef, has_leadin, voiced, lags, ltp, ltpscale, out_hist,
                              lpch_tail, dst, new_tail, rows, s);
    if (bw == 2)
        return (int)launch<2>(exc, gains, coef, has_leadin, voiced, lags, ltp, ltpscale, out_hist,
                              lpch_tail, dst, new_tail, rows, s);
    return (int)cudaErrorInvalidValue;
}
