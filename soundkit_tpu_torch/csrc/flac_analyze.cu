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
// Design: one block of THREADS threads a row. The row goes in tiles of TILE
// samples (one tile at FLAC's default block of 4096); a tile of L and R (as
// int32) and of the window w is staged in shared memory with the LPC_ORDER
// samples before it, zero outside [0, n_valid). A thread takes SPT consecutive
// samples and builds each candidate on the fly from L and R, keeping its samples
// and their history in registers, so a difference, a windowed product or an LPC
// tap reads a register. Three passes over the samples, each a block reduction
// (warp shuffles, then the warps in order, so the float64 sums are the same on
// every run and in the plain version):
//   A. per candidate, sum |d_o| and the count of d_o < 0 for o = 0..4 (the zigzag
//      sum of the chosen order is 2 sum|d| - negatives) and the nine lags of the
//      autocorrelation; then one thread a candidate picks the fixed order and its
//      Rice parameter, runs the Levinson recursion and quantizes;
//   B. the fixed residual's sum(u >> k), and the LPC residual's zigzag sum (its
//      Rice parameter's mean), for the candidates whose fit is accepted;
//   C. the LPC residual's sum(u >> k) for those candidates (skipped when none).
// Only samples below n_valid are visited. Samples are at most 24 bits (the side
// channel 25), so a fixed difference fits int32 and an LPC tap is one int32 x
// int32 -> int64 product (IMAD.WIDE) into a 64-bit sum.
//
// What bounds it on the card: operations (integer issue, then float64), not
// bytes: a row of 4096 stereo int16 samples is 16 KB read once, against ~20
// integer and ~20 float64 operations a sample and candidate.
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
constexpr int ORDER = 8;                 // LPC order, and the history a tile keeps
constexpr int PRECISION = 14;
constexpr int NFIX = 5;                  // fixed orders 0..4
constexpr int NLAG = ORDER + 1;
constexpr int NCAND = 4;
constexpr int PLAN = 23;
constexpr long long NO_LPC = 1LL << 50;
constexpr unsigned FULL = 0xffffffffu;

// A thread reads SPT consecutive slots: a slot of 32 bits is padded by one
// word every 32 and a float64 slot by one every 16, so the 32 threads of a
// warp read 32 banks
__host__ __device__ constexpr int pi(int j) { return j + (j >> 5); }
__host__ __device__ constexpr int pd(int j) { return j + (j >> 4); }

struct Shared {
    int32_t l[pi(ORDER + TILE)];         // samples tile0 - 8 .. tile0 + TILE - 1
    int32_t r[pi(ORDER + TILE)];
    double w[pd(ORDER + TILE)];
    long long ired[NCAND][WARPS][2 * NFIX];   // a warp's partial sums
    double dred[NCAND][WARPS][NLAG];
    long long fabs_[NCAND][NFIX], fneg[NCAND][NFIX];   // block totals
    double ac[NCAND][NLAG];
    long long fsum[NCAND], ltot[NCAND], lsum[NCAND];
    int fo[NCAND], fk[NCAND], lk[NCAND], shift[NCAND], ok[NCAND];
    int qlp[NCAND][ORDER];
};

__device__ __forceinline__ int32_t candidate(int c, int32_t l, int32_t r) {
    switch (c) {
        case 0: return l;
        case 1: return r;
        case 2: return l - r;
        default: return (l + r) >> 1;
    }
}

__device__ __forceinline__ int bit_length(unsigned long long v) {
    return v ? 64 - __clzll((long long)v) : 0;
}

// the reference's Rice parameter from a zigzag sum over n samples:
// k = max(bit_length(tot // max(n, 1)) - 2, 0)
__device__ __forceinline__ int rice_k(long long tot, long long n) {
    const long long mean = tot / (n > 1 ? n : 1);
    const int k = bit_length((unsigned long long)mean) - 2;
    return k > 0 ? k : 0;
}

__device__ __forceinline__ unsigned long long zigzag(long long r) {
    return ((unsigned long long)r << 1) ^ (unsigned long long)(r >> 63);
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
    for (int off = 16; off; off >>= 1) v += __shfl_down_sync(FULL, v, off);
    return v;
}

__device__ __forceinline__ double warp_dsum(double v) {
#pragma unroll
    for (int off = 16; off; off >>= 1) v = __dadd_rn(v, __shfl_down_sync(FULL, v, off));
    return v;
}

// the Welch window at sample g of a block of n_valid samples, rounded as the
// reference: t = (2g - (n - 1)) / max(n - 1, 1), w = 1 - t t
__device__ __forceinline__ double welch(int g, int n_valid) {
    const double den = (double)(n_valid - 1 > 1 ? n_valid - 1 : 1);
    const double t = __dsub_rn(2.0 * g, (double)(n_valid - 1)) / den;
    return __dsub_rn(1.0, __dmul_rn(t, t));
}

// stage the tile starting at sample tile0 (and the ORDER samples before it)
template <typename T>
__device__ void stage(Shared& s, const T* __restrict__ xl, const T* __restrict__ xr, int tile0,
                      int n_valid, bool mono, bool window) {
    for (int j = threadIdx.x; j < ORDER + TILE; j += THREADS) {
        const int g = tile0 - ORDER + j;
        const bool in = g >= 0 && g < n_valid;
        s.l[pi(j)] = in ? (int32_t)xl[g] : 0;
        s.r[pi(j)] = in && !mono ? (int32_t)xr[g] : 0;
        if (window) s.w[pd(j)] = in ? welch(g, n_valid) : 0.0;
    }
}

// a thread's samples of candidate c: v[m] is sample g0 - ORDER + m
__device__ __forceinline__ void load_window(const Shared& s, int c, int p0,
                                            int32_t (&v)[ORDER + SPT]) {
#pragma unroll
    for (int m = 0; m < ORDER + SPT; m++) v[m] = candidate(c, s.l[pi(p0 + m)], s.r[pi(p0 + m)]);
}

// the fixed differences d_0..d_4 at v[m], from the running differences of
// v[m - 1]; valid once four samples have passed
struct Diffs {
    int32_t d[NFIX];
    __device__ __forceinline__ void step(int32_t x) {
        int32_t e = x;
#pragma unroll
        for (int o = 0; o < NFIX; o++) {
            const int32_t next = e - d[o];
            d[o] = e;
            e = next;
        }
    }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flac_analyze_kernel(const T* __restrict__ x, int N, int n_valid, int bits, int channels,
                    int32_t* __restrict__ plans) {
    extern __shared__ __align__(16) unsigned char smem[];
    Shared& s = *reinterpret_cast<Shared*>(smem);
    const int row = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool mono = channels == 1;
    const int nc = mono ? 1 : NCAND;
    const T* xl = x + (size_t)row * 2 * N;
    const T* xr = xl + N;
    const int tiles = (n_valid + TILE - 1) / TILE;
    const int p0 = tid * SPT;                       // the thread's first history slot

    for (int t = tid; t < NCAND * NFIX; t += THREADS) {
        s.fabs_[t / NFIX][t % NFIX] = 0;
        s.fneg[t / NFIX][t % NFIX] = 0;
    }
    for (int t = tid; t < NCAND * NLAG; t += THREADS) s.ac[t / NLAG][t % NLAG] = 0.0;
    if (tid < NCAND) s.fsum[tid] = s.ltot[tid] = s.lsum[tid] = 0;

    // ---- pass A: fixed sums and negatives, autocorrelation
    for (int tile = 0; tile < tiles; tile++) {
        const int tile0 = tile * TILE;
        __syncthreads();
        stage(s, xl, xr, tile0, n_valid, mono, true);
        __syncthreads();
        const int g0 = tile0 + p0;                  // the thread's first sample
        for (int c = 0; c < nc; c++) {
            long long iacc[2 * NFIX] = {};
            double dacc[NLAG] = {};
            if (g0 < n_valid) {
                int32_t v[ORDER + SPT];
                load_window(s, c, p0, v);
                Diffs df = {};
#pragma unroll
                for (int m = ORDER - 4; m < ORDER + SPT; m++) {
                    df.step(v[m]);
                    const int g = g0 - ORDER + m;
                    if (m >= ORDER && g < n_valid) {
#pragma unroll
                        for (int o = 0; o < NFIX; o++) {
                            if (g >= o) {
                                const int32_t e = df.d[o];
                                iacc[o] += e < 0 ? -(long long)e : (long long)e;
                                iacc[NFIX + o] += e < 0;
                            }
                        }
                    }
                }
                double xw[ORDER + SPT];
#pragma unroll
                for (int m = 0; m < ORDER + SPT; m++)
                    xw[m] = __dmul_rn((double)v[m], s.w[pd(p0 + m)]);
#pragma unroll
                for (int m = ORDER; m < ORDER + SPT; m++) {
#pragma unroll
                    for (int lag = 0; lag < NLAG; lag++)
                        dacc[lag] = __dadd_rn(dacc[lag], __dmul_rn(xw[m - lag], xw[m]));
                }
            }
#pragma unroll
            for (int i = 0; i < 2 * NFIX; i++) {
                const long long v = warp_sum(iacc[i]);
                if (lane == 0) s.ired[c][warp][i] = v;
            }
#pragma unroll
            for (int i = 0; i < NLAG; i++) {
                const double v = warp_dsum(dacc[i]);
                if (lane == 0) s.dred[c][warp][i] = v;
            }
        }
        __syncthreads();
        for (int t = tid; t < nc * (2 * NFIX + NLAG); t += THREADS) {
            const int c = t / (2 * NFIX + NLAG), i = t % (2 * NFIX + NLAG);
            if (i < 2 * NFIX) {
                long long sum = 0;
                for (int wi = 0; wi < WARPS; wi++) sum += s.ired[c][wi][i];
                if (i < NFIX) s.fabs_[c][i] += sum;
                else s.fneg[c][i - NFIX] += sum;
            } else {
                double sum = s.dred[c][0][i - 2 * NFIX];
                for (int wi = 1; wi < WARPS; wi++) sum = __dadd_rn(sum, s.dred[c][wi][i - 2 * NFIX]);
                s.ac[c][i - 2 * NFIX] = __dadd_rn(s.ac[c][i - 2 * NFIX], sum);
            }
        }
    }
    __syncthreads();

    // ---- one thread a candidate: fixed order and its Rice parameter, Levinson, quantization
    if (tid < nc) {
        const int c = tid;
        int o = 0;
        for (int oo = 1; oo < NFIX; oo++)
            if (s.fabs_[c][oo] < s.fabs_[c][o]) o = oo;
        s.fo[c] = o;
        s.fk[c] = rice_k(2 * s.fabs_[c][o] - s.fneg[c][o], (long long)n_valid - o);

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
    bool lpc_any = false;
    for (int c = 0; c < nc; c++) lpc_any |= s.ok[c] != 0;

    // ---- passes B and C: the chosen fixed residual's sum(u >> k); the LPC
    // residual's zigzag sum (B), then its sum(u >> k) (C)
    for (int pass = 0; pass < 2; pass++) {
        if (pass == 1 && !lpc_any) break;
        for (int tile = 0; tile < tiles; tile++) {
            const int tile0 = tile * TILE;
            if (tiles > 1) {
                __syncthreads();
                stage(s, xl, xr, tile0, n_valid, mono, false);
                __syncthreads();
            }
            const int g0 = tile0 + p0;
            for (int c = 0; c < nc; c++) {
                long long facc = 0;
                unsigned long long lacc = 0;
                const bool lpc = s.ok[c] != 0;
                if (g0 < n_valid && (pass == 0 || lpc)) {
                    int32_t v[ORDER + SPT];
                    load_window(s, c, p0, v);
                    if (pass == 0) {
                        const int o = s.fo[c], k = s.fk[c];
                        Diffs df = {};
#pragma unroll
                        for (int m = ORDER - 4; m < ORDER + SPT; m++) {
                            df.step(v[m]);
                            const int g = g0 - ORDER + m;
                            if (m >= ORDER && g < n_valid && g >= o) {
                                int32_t e = df.d[0];
#pragma unroll
                                for (int oo = 1; oo < NFIX; oo++)
                                    if (oo == o) e = df.d[oo];
                                const unsigned u = ((unsigned)e << 1) ^ (unsigned)(e >> 31);
                                facc += k < 32 ? (long long)(u >> k) : 0;
                            }
                        }
                    }
                    if (lpc) {
                        int q[ORDER];
#pragma unroll
                        for (int j = 0; j < ORDER; j++) q[j] = s.qlp[c][j];
                        const int sh = s.shift[c];
                        const int k = pass ? s.lk[c] : 0;
#pragma unroll
                        for (int m = ORDER; m < ORDER + SPT; m++) {
                            const int g = g0 - ORDER + m;
                            if (g >= ORDER && g < n_valid) {
                                long long pred = 0;
#pragma unroll
                                for (int j = 0; j < ORDER; j++)
                                    pred += (long long)q[j] * (long long)v[m - 1 - j];
                                lacc += zigzag((long long)v[m] - (pred >> sh)) >> k;
                            }
                        }
                    }
                }
                const long long fv = warp_sum(facc);
                const unsigned long long lv = warp_sum(lacc);
                if (lane == 0) {
                    s.ired[c][warp][0] = fv;
                    s.ired[c][warp][1] = (long long)lv;
                }
            }
            __syncthreads();
            if (tid < nc) {
                long long f = 0, l = 0;
                for (int wi = 0; wi < WARPS; wi++) {
                    f += s.ired[tid][wi][0];
                    l += s.ired[tid][wi][1];
                }
                if (pass == 0) {
                    s.fsum[tid] += f;
                    s.ltot[tid] += l;
                } else {
                    s.lsum[tid] += l;
                }
            }
        }
        __syncthreads();
        if (pass == 0 && tid < nc) s.lk[tid] = rice_k(s.ltot[tid], (long long)n_valid - ORDER);
        __syncthreads();
    }

    // ---- kind per candidate, then the assignment; the plan row
    if (tid == 0) {
        long long ccost[NCAND];
        int kind[NCAND];
        for (int c = 0; c < nc; c++) {
            const int o = s.fo[c];
            const long long fcost = s.fsum[c] + ((long long)n_valid - o) * (1 + s.fk[c]) +
                                    (long long)o * bits + 8 + 6;
            const long long lcost = s.ok[c]
                ? s.lsum[c] + ((long long)n_valid - ORDER) * (1 + s.lk[c]) +
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

template <typename T>
int launch(const T* x, int rows, int n, int n_valid, int bits, int channels, int32_t* plans,
           cudaStream_t stream) {
    static bool ready = false;                 // the shared-memory attribute, set once
    if (!ready) {
        const cudaError_t e = cudaFuncSetAttribute(
            flac_analyze_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Shared));
        if (e != cudaSuccess) return (int)e;
        ready = true;
    }
    flac_analyze_kernel<T><<<rows, THREADS, sizeof(Shared), stream>>>(x, n, n_valid, bits,
                                                                       channels, plans);
    return (int)cudaGetLastError();
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
