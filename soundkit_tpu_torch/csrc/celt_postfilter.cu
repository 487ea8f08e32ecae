// K11: the CELT comb postfilter and de-emphasis of one 20 ms frame for every
// lane (the blocked lax.scan of soundkit_tpu/ops/celt_batch.py::_celt_synth_step
// and the validity mask of soundkit_tpu/models/opus_batch.py).
//
// One block a stream, one warp a channel; the warps never wait for each other.
// A warp holds its channel's line x = hist ++ frame (1200 + 960 floats) in shared
// memory and:
//   1. loads the line, with the carried overlap added to the frame's first 120
//      samples, and writes the new overlap (the IMDCT output's last 120);
//   2. runs the comb postfilter in steps of S samples, one a thread. Sample j
//      reads the filtered line at j - T - 2 .. j - T + 2; the periods lie in
//      [15, 1024] (pack_comb_params clamps them below to 15 and CELT's largest is
//      1022; the kernel clamps them to that range so that no read leaves the
//      line), so with S = min(32, Tmin - 2) every read of a step lies before the
//      step. A sample's value does not depend on S: each reads only finished
//      samples. The products and sums are rounded one by one (__fmul_rn,
//      __fadd_rn) in the reference's order;
//   3. the de-emphasis over blocks of 8 samples, out[k] = sum_{i<=k} c^(k-i) y[i]
//      + em c^(k+1), em the previous block's out[7]. Each block's 8-term sums
//      need only its own samples and em; em itself follows
//      em' = sum_i c^(7-i) y[i] + em c^8, so the threads first form the block
//      sums a[n], lane 0 walks em through the 120 blocks (a multiply and an add
//      each), and then every thread writes its samples' PCM;
//   4. writes the PCM (staged in the line's first 960 samples, which the comb
//      no longer reads), the new history (the line's last 1200 filtered
//      samples) and the new de-emphasis memory.
// The line moves between HBM and shared memory in 16-byte loads and stores, all
// of a lane's loads issued before its first store.
// A stream with valid 0 writes zero PCM and passes its overlap, history and
// de-emphasis memory through unchanged.
//
// Bound on the card: bytes (each channel reads its IMDCT output, overlap and
// history and writes its PCM, overlap and history, ~18.7 KB; a few FLOP a
// byte), then the serial chain of a line (the comb steps and the 120 blocks of
// the de-emphasis memory). The line stays in shared memory for both passes, so
// each byte crosses HBM once; the chain is cut to ceil(960 / S) comb steps and
// one multiply-add a block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 960;          // samples a frame
constexpr int OVERLAP = 120;
constexpr int HIST = 1200;      // carried filtered history
constexpr int LINE = HIST + N;  // the line a warp filters
constexpr int FULL = N + OVERLAP;
constexpr int BLK = 8;          // de-emphasis block
constexpr int NBLK = N / BLK;
constexpr int T_MIN = 15, T_MAX = 1024;
constexpr int WARP = 32;
// float32 table offsets: w^2 [120], then c^0 .. c^8 [9]
constexpr int T_W2 = 0, T_CPOW = OVERLAP, TABLE = OVERLAP + BLK + 1;

__device__ __forceinline__ int period(float v) {
    const int t = (int)v;  // truncation, as astype(int32)
    return t < T_MIN ? T_MIN : (t > T_MAX ? T_MAX : t);
}

// g0 x[p] + g1 (x[p-1] + x[p+1]) + g2 (x[p-2] + x[p+2]), rounded step by step
__device__ __forceinline__ float tap5(const float* x, int p, float g0, float g1, float g2) {
    const float a = __fmul_rn(g0, x[p]);
    const float b = __fmul_rn(g1, __fadd_rn(x[p - 1], x[p + 1]));
    const float c = __fmul_rn(g2, __fadd_rn(x[p - 2], x[p + 2]));
    return __fadd_rn(__fadd_rn(a, b), c);
}

// sum_{i<=k} c^(k-i) y[i], in order of i (the k-th column of the block's product)
__device__ __forceinline__ float deemph_sum(const float* y, int k, const float* cpow) {
    float acc = 0.f;
    for (int i = 0; i <= k; ++i) acc = __fadd_rn(acc, __fmul_rn(y[i], cpow[k - i]));
    return acc;
}

// ceil(n / WARP): the float4 moves a lane of a warp makes over n float4s
__host__ __device__ constexpr int per_lane(int n) { return (n + WARP - 1) / WARP; }

template <int C>
__global__ void __launch_bounds__(WARP * C)
celt_postfilter_kernel(const float* __restrict__ full, const float* __restrict__ comb,
                       const uint8_t* __restrict__ valid, const float* __restrict__ ola,
                       const float* __restrict__ hist, const float* __restrict__ emph,
                       const float* __restrict__ tables, float* __restrict__ pcm,
                       float* __restrict__ new_ola, float* __restrict__ new_hist,
                       float* __restrict__ new_emph) {
    __shared__ __align__(16) float line_s[C][LINE];
    __shared__ float em_s[C][NBLK + 1];  // block sums a[n], then em entering block n
    __shared__ float tab_s[TABLE];
    const int b = blockIdx.x, c = threadIdx.x / WARP, t = threadIdx.x % WARP;
    const size_t lane = (size_t)b * C + c;
    // every row starts on a 16-byte boundary (the wrapper checks the bases)
    const float4* f4 = reinterpret_cast<const float4*>(full + lane * FULL);
    const float4* o4 = reinterpret_cast<const float4*>(ola + lane * OVERLAP);
    const float4* h4 = reinterpret_cast<const float4*>(hist + lane * HIST);
    float4* no4 = reinterpret_cast<float4*>(new_ola + lane * OVERLAP);
    float4* nh4 = reinterpret_cast<float4*>(new_hist + lane * HIST);
    float4* p4 = reinterpret_cast<float4*>(pcm + lane * N);
    constexpr int H4 = HIST / 4, N4 = N / 4, O4 = OVERLAP / 4;

    if (!valid[b]) {
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int v = t; v < N4; v += WARP) p4[v] = zero;
        for (int v = t; v < O4; v += WARP) no4[v] = o4[v];
        for (int v = t; v < H4; v += WARP) nh4[v] = h4[v];
        if (t == 0) new_emph[lane] = emph[lane];
        return;
    }

    for (int i = threadIdx.x; i < TABLE; i += WARP * C) tab_s[i] = tables[i];
    float* x = line_s[c];
    float4* x4 = reinterpret_cast<float4*>(x);
    {
        // every load of the line in flight before the first store to shared memory
        float4 hv[per_lane(H4)], fv[per_lane(N4)], ov, nv;
#pragma unroll
        for (int k = 0; k < per_lane(H4); ++k)
            if (t + WARP * k < H4) hv[k] = h4[t + WARP * k];
#pragma unroll
        for (int k = 0; k < per_lane(N4); ++k)
            if (t + WARP * k < N4) fv[k] = f4[t + WARP * k];
        if (t < O4) {
            ov = o4[t];
            nv = f4[N4 + t];
        }
#pragma unroll
        for (int k = 0; k < per_lane(H4); ++k)
            if (t + WARP * k < H4) x4[t + WARP * k] = hv[k];
        if (t < O4) {  // the overlap-add: fv[0] holds float4 t of the frame
            fv[0] = make_float4(__fadd_rn(fv[0].x, ov.x), __fadd_rn(fv[0].y, ov.y),
                                __fadd_rn(fv[0].z, ov.z), __fadd_rn(fv[0].w, ov.w));
            no4[t] = nv;
        }
#pragma unroll
        for (int k = 0; k < per_lane(N4); ++k)
            if (t + WARP * k < N4) x4[H4 + t + WARP * k] = fv[k];
    }
    __syncthreads();  // the table (shared by the block's warps) and the line

    const float* cp = comb + (size_t)b * 16;
    const int ta0 = period(cp[0]), ta1 = period(cp[1]), tb0 = period(cp[8]), tb1 = period(cp[9]);
    const float ga0 = cp[2], ga1 = cp[3], ga2 = cp[4], gb0 = cp[5], gb1 = cp[6], gb2 = cp[7];
    const float gc0 = cp[10], gc1 = cp[11], gc2 = cp[12], gd0 = cp[13], gd1 = cp[14], gd2 = cp[15];
    const int tmin = min(min(ta0, ta1), min(tb0, tb1));
    const int S = min(WARP, tmin - 2);
    const float* w2 = tab_s + T_W2;

    // 2. comb postfilter, S samples a step
    for (int j0 = 0; j0 < N; j0 += S) {
        const int j = j0 + t;
        if (t < S && j < N) {
            const bool in_a = j < OVERLAP;
            const float f = j < OVERLAP ? w2[j] : (j < 2 * OVERLAP ? w2[j - OVERLAP] : 1.f);
            const int p = HIST + j;
            const float y0 = in_a ? tap5(x, p - ta0, ga0, ga1, ga2) : tap5(x, p - tb0, gc0, gc1, gc2);
            const float y1 = in_a ? tap5(x, p - ta1, gb0, gb1, gb2) : tap5(x, p - tb1, gd0, gd1, gd2);
            const float y = __fadd_rn(__fadd_rn(x[p], __fmul_rn(__fsub_rn(1.f, f), y0)),
                                      __fmul_rn(f, y1));
            x[p] = y;  // reads of this step all lie before j0
        }
        __syncwarp();
    }

    // 3. de-emphasis: block sums, the carried memory through the blocks, the PCM
    const float* cpow = tab_s + T_CPOW;
    const float* y = x + HIST;
    float* em = em_s[c];
    for (int n = t; n < NBLK; n += WARP) em[n + 1] = deemph_sum(y + BLK * n, BLK - 1, cpow);
    __syncwarp();
    if (t == 0) {
        const float c8 = cpow[BLK];
        float e = emph[lane];
        em[0] = e;
#pragma unroll 8
        for (int n = 0; n < NBLK; ++n) {
            e = __fadd_rn(em[n + 1], __fmul_rn(e, c8));
            em[n + 1] = e;
        }
        new_emph[lane] = e;
    }
    __syncwarp();
    // a thread's samples all sit at position k = t % 8 of their blocks: its
    // column of the block's product in registers, zero below the diagonal
    const int k = t % BLK;
    float col[BLK];
#pragma unroll
    for (int i = 0; i < BLK; ++i) col[i] = i <= k ? cpow[k - i] : 0.f;
    const float ck = cpow[k + 1];
    // the PCM into the line's first N samples, free once the comb has run
#pragma unroll 2
    for (int i = t; i < N; i += WARP) {
        const int n = i / BLK;
        const float* yb = y + BLK * n;
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < BLK; ++q) acc = __fadd_rn(acc, __fmul_rn(yb[q], col[q]));
        x[i] = __fadd_rn(acc, __fmul_rn(em[n], ck)) * (1.f / 32768.f);
    }
    __syncwarp();

    // 4. the PCM, and the new history: the line's last HIST filtered samples
    for (int v = t; v < N4; v += WARP) p4[v] = x4[v];
    for (int v = t; v < H4; v += WARP) nh4[v] = x4[N4 + v];
}

}  // namespace

extern "C" int skt_celt_postfilter(const float* full, const float* comb, const uint8_t* valid,
                                   const float* ola, const float* hist, const float* emph,
                                   const float* tables, float* pcm, float* new_ola,
                                   float* new_hist, float* new_emph, int B, int C, void* stream) {
    if (B <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (C == 2)
        celt_postfilter_kernel<2><<<(unsigned)B, WARP * 2, 0, s>>>(
            full, comb, valid, ola, hist, emph, tables, pcm, new_ola, new_hist, new_emph);
    else if (C == 1)
        celt_postfilter_kernel<1><<<(unsigned)B, WARP, 0, s>>>(
            full, comb, valid, ola, hist, emph, tables, pcm, new_ola, new_hist, new_emph);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
