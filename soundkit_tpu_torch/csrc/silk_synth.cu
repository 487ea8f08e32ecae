// K12: the SILK LTP/LPC synthesis of one 20 ms frame for every (lane, channel)
// row (synth_frame of soundkit_tpu/ops/silk_batch.py, its lax.scan at :229): one
// launch a silk_round.
//
// A row carries its output line dst = out_hist (322) ++ the frame (4 x sfl) and
// its residual line res = 290 zeros ++ the frame's excitation, both in shared
// memory. For each of the 4 subframes, in order:
//   (b) the voiced re-whitening: over the 290 line positions before the
//       subframe, an order-`order` FIR of dst, clipped, times rescale / g_i,
//       replaces the residual on [-lag - 2, out_end); for i > 0 the residual on
//       [out_end, 0) is scaled by g_{i-1} / g_i. Only the positions a row's mask
//       takes are computed; the block's threads share them;
//   (c1) the 5-tap LTP: r_j = e_j + sum_k ltp[k] res[j - lag + 2 - k], written
//       back into the residual. The newest sample a tap reads lies lag - 2 >= 1
//       back, so a warp takes S = min(32, lag - 2) samples a step, every read of
//       a step lying before it (as K11's comb does);
//   (c2) the LPC all-pole filter u_j = r_j g_i + sum_k coeff[k] u_{j-1-k}, one
//       thread a row, the 16-sample tail in registers; clip(u_j) goes to dst and
//       the unclipped u_j into the tail.
// Every product and sum is rounded alone (__fmul_rn, __fadd_rn, __fdiv_rn) in
// the order of the plain version (ops/silk_synth.py): the FIR and the LTP sums
// over k ascending from 0; the LPC as (r_j g_i + T) + coeff[0] u_{j-1}, T the
// pairwise sum of coeff[k] u_{j-1-k} for k from order - 1 down to 1. So the chain
// from one sample to the next is one product and one add, and the rest of a
// sample is four levels of independent adds: the LPC thread is bound by what it
// issues (~2 order + 4 instructions a sample), not by a chain of order adds (a
// sequential sum measured ~105 cycles a sample on the card).
// Lags are clamped to [3, 288] on both paths (valid streams: 16..288), so that no
// read leaves the lines; a row of zeros, or any row, never faults.
//
// Bound on the card: the LPC recursion. The bytes are ~5.5 KB a row in and out;
// the LPC is a serial recursion of 4 sfl samples a row, ~2 order + 4
// instructions a sample on one thread (the FIR and the LTP spread over the
// block's 8 warps). The design keeps both lines in shared memory for the whole
// frame, so each byte crosses HBM once, and leaves the LPC thread nothing but its
// own arithmetic, its r_j g_i taken CHUNK samples ahead.
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
constexpr int ROWS = 8;          // rows a block
constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / WARP;

template <int BW> struct Geo;
template <> struct Geo<0> { static constexpr int SFL = 40, ORDER = 10; };  // NB
template <> struct Geo<1> { static constexpr int SFL = 60, ORDER = 10; };  // MB
template <> struct Geo<2> { static constexpr int SFL = 80, ORDER = 16; };  // WB

template <int SFL> struct Smem {
    float dst[ROWS][HIST + SUB * SFL];
    float res[ROWS][MAXLAG + SUB * SFL];
    float gains[ROWS][SUB];
    float coef[ROWS][2][TAIL];
    float ltp[ROWS][SUB][LTP_ORDER];
    float ltpscale[ROWS];
    int lags[ROWS][SUB];
    int voiced[ROWS];
    int lead[ROWS];
};

// clip to [-1, 1] as jnp.clip / torch.clamp do: a NaN passes through
__device__ __forceinline__ float clip1(float v) { return v < -1.f ? -1.f : (v > 1.f ? 1.f : v); }

__device__ __forceinline__ int clamp_lag(int lag) {
    return lag < LAG_MIN ? LAG_MIN : (lag > LAG_MAX ? LAG_MAX : lag);
}

// out_end of subframe i: the end of the re-whitened span, relative to its start
__device__ __forceinline__ int out_end(int i, bool lead, int sfl) {
    return (i >= 2 && lead) ? -(i - 2) * sfl : -i * sfl;
}

// (b): the voiced re-whitening of subframe i, the block's threads over the
// (row, position) pairs
template <int BW>
__device__ __forceinline__ void rewhiten(Smem<Geo<BW>::SFL>& sm, int i, int tid) {
    constexpr int SFL = Geo<BW>::SFL, ORDER = Geo<BW>::ORDER;
    const int r0 = MAXLAG + i * SFL, d0 = HIST + i * SFL;
    for (int e = tid; e < ROWS * MAXLAG; e += THREADS) {
        const int r = e / MAXLAG;
        if (!sm.voiced[r]) continue;
        const int rel = e - r * MAXLAG - MAXLAG;  // -290 .. -1
        const bool lead = sm.lead[r] != 0;
        const int end = out_end(i, lead, SFL);
        const int start = -clamp_lag(sm.lags[r][i]) - LTP_ORDER / 2;
        const float g = sm.gains[r][i];
        float* res = sm.res[r];
        if (rel >= start && rel < end) {
            const float* c = sm.coef[r][(i < 2 && lead) ? 0 : 1];
            const float* d = sm.dst[r] + d0 + rel;
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < ORDER; ++k) acc = __fadd_rn(acc, __fmul_rn(d[-1 - k], c[k]));
            const float v = clip1(__fsub_rn(d[0], acc));
            const float rescale = (i >= 2 && lead) ? 1.f : sm.ltpscale[r];
            res[r0 + rel] = __fmul_rn(v, __fdiv_rn(rescale, g));
        } else if (i > 0 && rel >= end) {
            res[r0 + rel] = __fmul_rn(res[r0 + rel], __fdiv_rn(sm.gains[r][i - 1], g));
        }
    }
}

// (c1): the LTP of subframe i into the residual, a warp a voiced row
template <int BW>
__device__ __forceinline__ void ltp_residual(Smem<Geo<BW>::SFL>& sm, int i, int tid) {
    constexpr int SFL = Geo<BW>::SFL;
    const int w = tid / WARP, t = tid % WARP;
    const int r0 = MAXLAG + i * SFL;
    for (int r = w; r < ROWS; r += NWARP) {
        if (!sm.voiced[r]) continue;  // uniform over the warp
        const int lag = clamp_lag(sm.lags[r][i]);
        const int S = min(WARP, lag - 2);
        const float* tp = sm.ltp[r][i];
        float* res = sm.res[r];
        for (int j0 = 0; j0 < SFL; j0 += S) {
            const int j = j0 + t;
            if (t < S && j < SFL) {
                const float* past = res + r0 + j - lag + LTP_ORDER / 2;
                float acc = 0.f;
#pragma unroll
                for (int k = 0; k < LTP_ORDER; ++k) acc = __fadd_rn(acc, __fmul_rn(tp[k], past[-k]));
                res[r0 + j] = __fadd_rn(res[r0 + j], acc);  // reads of this step lie before j0
            }
            __syncwarp();
        }
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

// (c2): the LPC filter of subframe i for row r, the tail in registers:
// u_j = (r_j g + tree(coeff[k] u_{j-1-k}, k = order-1 .. 1)) + coeff[0] u_{j-1}
template <int BW>
__device__ __forceinline__ void lpc_subframe(Smem<Geo<BW>::SFL>& sm, int i, int r,
                                             float (&tail)[TAIL]) {
    constexpr int SFL = Geo<BW>::SFL, ORDER = Geo<BW>::ORDER;
    constexpr int CHUNK = 20;  // r_j g taken ahead, CHUNK samples at a time
    const bool lead = sm.lead[r] != 0;
    const float* cs = sm.coef[r][(i < 2 && lead) ? 0 : 1];
    float c[ORDER];
#pragma unroll
    for (int k = 0; k < ORDER; ++k) c[k] = cs[k];
    const float g = sm.gains[r][i];
    const float* __restrict__ res = sm.res[r] + MAXLAG + i * SFL;
    float* __restrict__ d = sm.dst[r] + HIST + i * SFL;
#pragma unroll
    for (int j0 = 0; j0 < SFL; j0 += CHUNK) {
        float rg[CHUNK];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) rg[j] = __fmul_rn(res[j0 + j], g);
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            float t[ORDER - 1];
#pragma unroll
            for (int k = ORDER - 1; k >= 1; --k) t[ORDER - 1 - k] = __fmul_rn(c[k], tail[k]);
            const float u = __fadd_rn(__fadd_rn(rg[j], tree_sum<ORDER - 1>(t)),
                                      __fmul_rn(c[0], tail[0]));
#pragma unroll
            for (int k = TAIL - 1; k > 0; --k) tail[k] = tail[k - 1];
            tail[0] = u;
            d[j0 + j] = clip1(u);
        }
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
    constexpr int SFL = Geo<BW>::SFL, FLEN = SUB * SFL, DLEN = HIST + FLEN;
    extern __shared__ float4 smem_raw[];  // dynamic: above the 48 KB of static shared memory
    Smem<SFL>& sm = *reinterpret_cast<Smem<SFL>*>(smem_raw);
    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * ROWS;
    const int nr = min(ROWS, rows - row0);

    // the lines and the rows' parameters; rows past the end read as zeros
    for (int e = tid; e < ROWS * HIST; e += THREADS) {
        const int r = e / HIST;
        sm.dst[r][e - r * HIST] = r < nr ? out_hist[(size_t)row0 * HIST + e] : 0.f;
    }
    for (int e = tid; e < ROWS * MAXLAG; e += THREADS) {
        const int r = e / MAXLAG;
        sm.res[r][e - r * MAXLAG] = 0.f;
    }
    for (int e = tid; e < ROWS * FLEN; e += THREADS) {
        const int r = e / FLEN, j = e - r * FLEN;
        sm.res[r][MAXLAG + j] = r < nr ? exc[(size_t)(row0 + r) * EXC + j] : 0.f;
    }
    for (int e = tid; e < ROWS * SUB; e += THREADS) {
        const int r = e / SUB, k = e - r * SUB;
        sm.gains[r][k] = r < nr ? gains[(size_t)row0 * SUB + e] : 0.f;
        sm.lags[r][k] = r < nr ? lags[(size_t)row0 * SUB + e] : 0;
    }
    for (int e = tid; e < ROWS * 2 * TAIL; e += THREADS) {
        const int r = e / (2 * TAIL), k = e - r * 2 * TAIL;
        sm.coef[r][k / TAIL][k % TAIL] = r < nr ? coef[(size_t)row0 * 2 * TAIL + e] : 0.f;
    }
    for (int e = tid; e < ROWS * SUB * LTP_ORDER; e += THREADS) {
        const int r = e / (SUB * LTP_ORDER), k = e - r * SUB * LTP_ORDER;
        sm.ltp[r][k / LTP_ORDER][k % LTP_ORDER] =
            r < nr ? ltp[(size_t)row0 * SUB * LTP_ORDER + e] : 0.f;
    }
    if (tid < ROWS) {
        const bool in = tid < nr;
        sm.ltpscale[tid] = in ? ltpscale[row0 + tid] : 0.f;
        sm.voiced[tid] = in ? voiced[row0 + tid] : 0;
        sm.lead[tid] = in ? has_leadin[row0 + tid] : 0;
    }
    float tail[TAIL];
    if (tid < ROWS) {
#pragma unroll
        for (int k = 0; k < TAIL; ++k)
            tail[k] = tid < nr ? lpch_tail[(size_t)(row0 + tid) * TAIL + k] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int i = 0; i < SUB; ++i) {
        rewhiten<BW>(sm, i, tid);
        __syncthreads();
        ltp_residual<BW>(sm, i, tid);
        __syncthreads();
        if (tid < ROWS) lpc_subframe<BW>(sm, i, tid, tail);
        __syncthreads();
    }

    for (int e = tid; e < nr * DLEN; e += THREADS) {
        const int r = e / DLEN;
        dst[(size_t)row0 * DLEN + e] = sm.dst[r][e - r * DLEN];
    }
    if (tid < nr) {
#pragma unroll
        for (int k = 0; k < TAIL; ++k) new_tail[(size_t)(row0 + tid) * TAIL + k] = tail[k];
    }
}

template <int BW>
cudaError_t launch(const float* exc, const float* gains, const float* coef, const int* has_leadin,
                   const int* voiced, const int* lags, const float* ltp, const float* ltpscale,
                   const float* out_hist, const float* lpch_tail, float* dst, float* new_tail,
                   int rows, cudaStream_t s) {
    constexpr size_t SMEM = sizeof(Smem<Geo<BW>::SFL>);
    static const cudaError_t attr = cudaFuncSetAttribute(
        silk_synth_kernel<BW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (attr != cudaSuccess) return attr;
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
