// K11: the CELT comb postfilter and de-emphasis of one 20 ms frame for every
// lane (the blocked lax.scan of soundkit_tpu/ops/celt_batch.py::_celt_synth_step
// and the validity mask of soundkit_tpu/models/opus_batch.py).
//
// A unit is one channel of one stream. Its line x = hist ++ frame (1200 + 960
// floats) lives in shared memory, the frame's first 120 samples with the carried
// overlap added. Per unit:
//   1. the comb postfilter: sample j reads the filtered line at j - T - 2 ..
//      j - T + 2 for the tap sets it uses: set a (periods comb[0:2], gains
//      comb[2:8], crossfade w^2[j]) for j < 120, set b (comb[8:10], comb[10:16],
//      w^2[j - 120]) for 120 <= j < 240, and set b's second tap alone for j >=
//      240, where the crossfade weight of the first is 1 - 1 = 0. The periods lie
//      in [15, 1024] (pack_comb_params clamps them below to 15, CELT's largest is
//      1022; the kernel clamps them to that range so that no read leaves the
//      line). A region's step width is bounded only by the periods of the taps
//      its samples read with nonzero gains: S = min(128, Tmin - 2) samples, up
//      to 4 a lane, every read of a step lying before the step. A tap whose three gains
//      are zero reads at its region's other period (finished samples, fetched
//      anyway), and a region with no active tap, or a frame whose four gain
//      triples are all zero, runs no comb. Such a term is zero gains x a value =
//      +-0 on both paths, so a sample differs from the plain version only in the
//      sign of a zero, or where a read the kernel skips is not finite (the plain
//      version then gives NaN). The products and
//      sums are rounded one by one (__fmul_rn, __fadd_rn) in the reference's order;
//   2. the de-emphasis over blocks of 8 samples, out[k] = sum_{i<=k} c^(k-i) y[i]
//      + em c^(k+1), em the previous block's out[7], so em' = a_n + em m with a_n
//      = sum_i c^(7-i) y[i] and m = c^8. A lane takes blocks l, l + 32, l + 64 and
//      l + 96: it forms their a_n, the carried memory goes through each round of
//      32 blocks as a warp scan of the affine maps (Kogge-Stone, 5 shuffle levels,
//      m^d from the table), and each lane then writes its blocks' PCM. The scan
//      sums in another order than the plain version's sequential walk (within its
//      1e-5 bound);
//   3. the PCM (staged in the line's first 960 samples, which the comb no longer
//      reads), the new history (the line's last 1200 filtered samples), the new
//      overlap (the IMDCT output's last 120) and de-emphasis memory are written.
// A stream with valid 0 writes zero PCM and passes its overlap, history and
// de-emphasis memory through unchanged.
//
// Bound on the card: bytes (each channel reads its IMDCT output, overlap and the
// part of its history the comb reaches and writes its PCM, overlap and history,
// up to ~18.7 KB; a few FLOP a byte). So the copies overlap the serial work
// across warps: a warp a unit, its line alone in 8.6 KB of shared memory, so that
// a 1024-stream stereo round (2048 warps, ~16 an SM) is resident at once; each
// warp fetches only the history its comb reaches, by 16-byte cp.async, its
// overlaps into registers, and stores as soon as it has filtered, so that the
// warps whose lines arrive first filter and store while the others' loads are
// still in flight. Each byte crosses HBM once. (A persistent grid that brought
// each warp's next unit into a second buffer while it filtered the first measured
// slower on the path and on the random frames: a stream with narrow comb steps
// then held another unit behind its ~76-step chain.)
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
constexpr unsigned ALL = 0xffffffffu;
constexpr int WARPS = 4;        // warps a block, a unit a warp
constexpr int NS = 4;           // comb samples a lane a step
constexpr int SMAX = WARP * NS; // the widest comb step
constexpr int ROUNDS = (NBLK + WARP - 1) / WARP;  // de-emphasis blocks a lane
// float32 table offsets: w^2 [120], c^0 .. c^8 [9], m^0 .. m^32 [33] (m = c^8)
constexpr int T_W2 = 0, T_CPOW = OVERLAP, T_MPOW = T_CPOW + BLK + 1, TABLE = T_MPOW + WARP + 1;
constexpr int TABLE_PAD = (TABLE + 3) / 4 * 4;

__device__ __forceinline__ int period(float v) {
    const int t = (int)v;  // truncation, as astype(int32)
    return t < T_MIN ? T_MIN : (t > T_MAX ? T_MAX : t);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
}

// g0 w[2] + g1 (w[1] + w[3]) + g2 (w[0] + w[4]) for the window w = x[p-2 .. p+2],
// rounded step by step
__device__ __forceinline__ float tap5(const float (&w)[5], const float (&g)[3]) {
    const float a = __fmul_rn(g[0], w[2]);
    const float b = __fmul_rn(g[1], __fadd_rn(w[1], w[3]));
    const float c = __fmul_rn(g[2], __fadd_rn(w[0], w[4]));
    return __fadd_rn(__fadd_rn(a, b), c);
}

// a unit's comb parameters: lane k < 16 holds comb[b][k]
struct Params {
    float comb;
    float emph;
    int valid;
};

// the comb's regions for one unit: the periods each tap reads at, the step width
// (0: the region runs no comb), and the first line position any of them reads
struct Plan {
    int a0, a1, b0, b1, b2, sa, sb, s2, lo;
};

__device__ __forceinline__ Params load_params(int u, int C, const float* __restrict__ comb,
                                              const uint8_t* __restrict__ valid,
                                              const float* __restrict__ emph, int lane) {
    const int b = u / C;
    Params p;
    p.comb = lane < 16 ? comb[(size_t)b * 16 + lane] : 0.f;
    p.emph = emph[u];
    p.valid = valid[b];
    return p;
}

__device__ __forceinline__ Plan make_plan(const Params& p, int lane) {
    // gains: comb[2:5] and [5:8] (set a), [10:13] and [13:16] (set b)
    const unsigned nz = __ballot_sync(ALL, p.valid && lane < 16 && p.comb != 0.f);
    const bool ga = nz & 0x1cu, gb = nz & 0xe0u, gc = nz & 0x1c00u, gd = nz & 0xe000u;
    const int ta0 = period(__shfl_sync(ALL, p.comb, 0)), ta1 = period(__shfl_sync(ALL, p.comb, 1));
    const int tb0 = period(__shfl_sync(ALL, p.comb, 8)), tb1 = period(__shfl_sync(ALL, p.comb, 9));
    Plan q;
    q.lo = N;  // the new history starts there
    q.a0 = ga ? ta0 : ta1, q.a1 = gb ? ta1 : ta0;
    q.sa = (ga || gb) ? min(SMAX, min(q.a0, q.a1) - 2) : 0;
    if (q.sa) q.lo = min(q.lo, HIST - max(q.a0, q.a1) - 2);
    q.b0 = gc ? tb0 : tb1, q.b1 = gd ? tb1 : tb0;
    q.sb = (gc || gd) ? min(SMAX, min(q.b0, q.b1) - 2) : 0;
    if (q.sb) q.lo = min(q.lo, HIST + OVERLAP - max(q.b0, q.b1) - 2);
    q.b2 = tb1;
    q.s2 = gd ? min(SMAX, tb1 - 2) : 0;
    if (q.s2) q.lo = min(q.lo, HIST + 2 * OVERLAP - tb1 - 2);
    q.lo &= ~3;
    return q;
}

// a unit's carried overlap and new overlap (the IMDCT output's last 120), 16
// bytes on each of lanes 0-29
struct Overlaps {
    float4 ola, nola;
};

// the unit's line into buf by cp.async (valid: the history the comb reaches and
// the frame; invalid: the whole history) and its overlaps into registers
__device__ __forceinline__ Overlaps fetch(float* buf, int u, const Params& p, const Plan& q,
                                          const float* __restrict__ full,
                                          const float* __restrict__ ola,
                                          const float* __restrict__ hist, int lane) {
    const float4* h4 = reinterpret_cast<const float4*>(hist + (size_t)u * HIST);
    const float4* f4 = reinterpret_cast<const float4*>(full + (size_t)u * FULL);
    float4* b4 = reinterpret_cast<float4*>(buf);
    const int h0 = p.valid ? q.lo / 4 : 0;
    for (int v = h0 + lane; v < HIST / 4; v += WARP) cp_async16(b4 + v, h4 + v);
    if (p.valid)
        for (int v = lane; v < N / 4; v += WARP) cp_async16(b4 + HIST / 4 + v, f4 + v);
    Overlaps o = {};
    if (lane < OVERLAP / 4) {
        o.ola = reinterpret_cast<const float4*>(ola + (size_t)u * OVERLAP)[lane];
        if (p.valid) o.nola = f4[N / 4 + lane];
    }
    return o;
}

// samples [js, je) of the comb at S <= 32 NSLOT samples a step, a lane taking
// samples lane + 32 m, m < NSLOT. XF: the crossfade y = x + (1 - f) tap5(T0, g0)
// + f tap5(T1, g1), f = fw[j - js]; else f = 1 and y = x + tap5(T1, g1)
template <bool XF, int NSLOT>
__device__ __forceinline__ void comb_steps(float* x, int js, int je, int S, int T0, int T1,
                                           const float (&g0)[3], const float (&g1)[3],
                                           const float* fw, int lane) {
    int jl[NSLOT];  // a lane's samples in a step (a lane past the step repeats its last)
#pragma unroll
    for (int m = 0; m < NSLOT; ++m) jl[m] = min(lane + WARP * m, S - 1);
#pragma unroll 1
    for (int j0 = js; j0 < je; j0 += S) {
        float xv[NSLOT], w0[NSLOT][5], w1[NSLOT][5], f[NSLOT];
        // every read of the step first: they all lie before it
#pragma unroll
        for (int m = 0; m < NSLOT; ++m) {
            const int j = min(j0 + jl[m], je - 1);
            xv[m] = x[j];
#pragma unroll
            for (int k = 0; k < 5; ++k) w1[m][k] = x[j - T1 - 2 + k];
            if (XF) {
#pragma unroll
                for (int k = 0; k < 5; ++k) w0[m][k] = x[j - T0 - 2 + k];
                f[m] = fw[j - js];
            }
        }
#pragma unroll
        for (int m = 0; m < NSLOT; ++m) {
            const float y1 = tap5(w1[m], g1);
            float y;
            if (XF) {
                const float y0 = tap5(w0[m], g0);
                y = __fadd_rn(__fadd_rn(xv[m], __fmul_rn(__fsub_rn(1.f, f[m]), y0)),
                              __fmul_rn(f[m], y1));
            } else {
                y = __fadd_rn(xv[m], y1);
            }
            const int jj = lane + WARP * m;
            if (jj < S && j0 + jj < je) x[j0 + jj] = y;
        }
        __syncwarp();
    }
}

// samples [js, je) of the comb at S samples a step, with as many samples a lane
// as the step needs
template <bool XF>
__device__ __forceinline__ void comb_region(float* x, int js, int je, int S, int T0, int T1,
                                            const float (&g0)[3], const float (&g1)[3],
                                            const float* fw, int lane) {
    if (S <= WARP)
        comb_steps<XF, 1>(x, js, je, S, T0, T1, g0, g1, fw, lane);
    else if (S <= 2 * WARP)
        comb_steps<XF, 2>(x, js, je, S, T0, T1, g0, g1, fw, lane);
    else
        comb_steps<XF, NS>(x, js, je, S, T0, T1, g0, g1, fw, lane);
}

__device__ __forceinline__ void gains3(float (&g)[3], float v, int first) {
#pragma unroll
    for (int k = 0; k < 3; ++k) g[k] = __shfl_sync(ALL, v, first + k);
}

// the comb and the de-emphasis of the unit in buf, its PCM into the line's first
// N samples; the new de-emphasis memory is returned (on every lane). Every lane
// runs it, for an invalid unit too (no comb, no stores), so that its shuffles
// are never in divergent code
__device__ __forceinline__ float filter(float* buf, const Params& p, const Plan& q,
                                        const float4& ola, const float* tab, int lane) {
    // the table's powers into registers before the first store
    float cpow[BLK + 1], mlev[5];
#pragma unroll
    for (int k = 0; k <= BLK; ++k) cpow[k] = tab[T_CPOW + k];
#pragma unroll
    for (int k = 0; k < 5; ++k) mlev[k] = tab[T_MPOW + (1 << k)];
    const float mlane = tab[T_MPOW + lane + 1];
    float* x = buf + HIST;  // the frame; x[j - T] reaches back into the history
    if (p.valid && lane < OVERLAP / 4) {  // the overlap-add
        float4* x4 = reinterpret_cast<float4*>(x);
        float4 v = x4[lane];
        v = make_float4(__fadd_rn(v.x, ola.x), __fadd_rn(v.y, ola.y), __fadd_rn(v.z, ola.z),
                        __fadd_rn(v.w, ola.w));
        x4[lane] = v;
    }
    __syncwarp();

    // 1. the comb
    float ga[3], gb[3], gc[3], gd[3];
    gains3(ga, p.comb, 2), gains3(gb, p.comb, 5), gains3(gc, p.comb, 10), gains3(gd, p.comb, 13);
    const float* w2 = tab + T_W2;
    if (q.sa) comb_region<true>(x, 0, OVERLAP, q.sa, q.a0, q.a1, ga, gb, w2, lane);
    if (q.sb) comb_region<true>(x, OVERLAP, 2 * OVERLAP, q.sb, q.b0, q.b1, gc, gd, w2, lane);
    if (q.s2) comb_region<false>(x, 2 * OVERLAP, N, q.s2, q.b2, q.b2, gd, gd, w2, lane);

    // 2. the de-emphasis: lane l takes blocks l + 32 r
    float y[ROUNDS][BLK], a[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const int n = min(lane + WARP * r, NBLK - 1);
        const float4* y4 = reinterpret_cast<const float4*>(x + BLK * n);
        const float4 lo = y4[0], hi = y4[1];
        y[r][0] = lo.x, y[r][1] = lo.y, y[r][2] = lo.z, y[r][3] = lo.w;
        y[r][4] = hi.x, y[r][5] = hi.y, y[r][6] = hi.z, y[r][7] = hi.w;
        float acc = 0.f;  // a_n = sum_i c^(7-i) y[i], in order of i
#pragma unroll
        for (int i = 0; i < BLK; ++i) acc = __fadd_rn(acc, __fmul_rn(y[r][i], cpow[BLK - 1 - i]));
        a[r] = lane + WARP * r < NBLK ? acc : 0.f;
    }
    float em = p.emph;  // entering the round's first block
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        // S_l = sum_{l' <= l} a_l' m^(l - l'), five levels
        float s = a[r];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            const float t = __shfl_up_sync(ALL, s, 1 << k);
            if (lane >= (1 << k)) s = __fadd_rn(s, __fmul_rn(mlev[k], t));
        }
        const float e = __fadd_rn(s, __fmul_rn(mlane, em));  // after block l
        const float up = __shfl_up_sync(ALL, e, 1);
        const float em_in = lane == 0 ? em : up;  // entering block l
        const int n = lane + WARP * r;
        float out[BLK];
#pragma unroll
        for (int k = 0; k < BLK; ++k) {
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i <= k; ++i) acc = __fadd_rn(acc, __fmul_rn(y[r][i], cpow[k - i]));
            out[k] = __fadd_rn(acc, __fmul_rn(em_in, cpow[k + 1])) * (1.f / 32768.f);
        }
        if (p.valid && n < NBLK) {
            // the PCM into the line's first N samples, free once the comb has run
            float4* o4 = reinterpret_cast<float4*>(buf + BLK * n);
            o4[0] = make_float4(out[0], out[1], out[2], out[3]);
            o4[1] = make_float4(out[4], out[5], out[6], out[7]);
        }
        em = __shfl_sync(ALL, e, min(WARP, NBLK - WARP * r) - 1);
    }
    __syncwarp();
    return em;
}

__global__ void __launch_bounds__(WARP * WARPS)
celt_postfilter_kernel(const float* __restrict__ full, const float* __restrict__ comb,
                       const uint8_t* __restrict__ valid, const float* __restrict__ ola,
                       const float* __restrict__ hist, const float* __restrict__ emph,
                       const float* __restrict__ tables, float* __restrict__ pcm,
                       float* __restrict__ new_ola, float* __restrict__ new_hist,
                       float* __restrict__ new_emph, int units, int C) {
    extern __shared__ float4 smem_raw[];
    float* tab = reinterpret_cast<float*>(smem_raw);
    for (int i = threadIdx.x; i < TABLE; i += blockDim.x) tab[i] = tables[i];
    __syncthreads();  // the block's only barrier: the table
    const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    const int u = blockIdx.x * WARPS + w;
    if (u >= units) return;
    float* buf = tab + TABLE_PAD + (size_t)w * LINE;

    const Params p = load_params(u, C, comb, valid, emph, lane);
    const Plan q = make_plan(p, lane);
    const Overlaps o = fetch(buf, u, p, q, full, ola, hist, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();

    const float em = filter(buf, p, q, o.ola, tab, lane);
    const float4* b4 = reinterpret_cast<const float4*>(buf);
    float4* p4 = reinterpret_cast<float4*>(pcm + (size_t)u * N);
    float4* nh4 = reinterpret_cast<float4*>(new_hist + (size_t)u * HIST);
    float4* no4 = reinterpret_cast<float4*>(new_ola + (size_t)u * OVERLAP);
    if (p.valid) {
#pragma unroll 4
        for (int v = lane; v < N / 4; v += WARP) p4[v] = b4[v];
#pragma unroll 4
        for (int v = lane; v < HIST / 4; v += WARP) nh4[v] = b4[N / 4 + v];
        if (lane < OVERLAP / 4) no4[lane] = o.nola;
        if (lane == 0) new_emph[u] = em;
    } else {
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int v = lane; v < N / 4; v += WARP) p4[v] = zero;
#pragma unroll 4
        for (int v = lane; v < HIST / 4; v += WARP) nh4[v] = b4[v];
        if (lane < OVERLAP / 4) no4[lane] = o.ola;
        if (lane == 0) new_emph[u] = p.emph;
    }
}

}  // namespace

extern "C" int skt_celt_postfilter(const float* full, const float* comb, const uint8_t* valid,
                                   const float* ola, const float* hist, const float* emph,
                                   const float* tables, float* pcm, float* new_ola,
                                   float* new_hist, float* new_emph, int B, int C, void* stream) {
    if (B <= 0) return 0;
    if (C != 1 && C != 2) return (int)cudaErrorInvalidValue;
    constexpr size_t SMEM = (TABLE_PAD + (size_t)WARPS * LINE) * sizeof(float);  // under 48 KB
    const int units = B * C;
    celt_postfilter_kernel<<<(unsigned)((units + WARPS - 1) / WARPS), WARP * WARPS, SMEM,
                             (cudaStream_t)stream>>>(full, comb, valid, ola, hist, emph, tables,
                                                     pcm, new_ola, new_hist, new_emph, units, C);
    return (int)cudaGetLastError();
}
