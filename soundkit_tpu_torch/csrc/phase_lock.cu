// K17: the identity phase locking and resynthesis of the device phase vocoder:
// soundkit_tpu/ops/stretch.py::stretch_batch_device (:256-274), the peak test,
// the lax.cummax forward fill and lax.cummin backward fill of peak indices, the
// nearest peak, the two take_along_axis gathers and mag * exp(1j * syn) (XLA
// there, no Pallas kernel).
//
// Inputs: mag, phase and syn (the accumulated synthesis phase) f32 [rows, K],
// rows = B x T frames. Output: the complex64 spectrum [rows, K] (interleaved
// float2), and, where nearest is not null, each bin's nearest peak int32
// [rows, K]. Per row and bin k:
//   is_peak[k] = mag[k] >= mag[k-1] && mag[k] > mag[k+1]  (-inf past both ends)
//   ffill[k]   = the last peak at or before k (-1 if none)
//   bfill[k]   = the first peak at or after k (2K if none)
//   nearest[k] = ffill[k] if k - ffill[k] <= bfill[k] - k, else bfill[k]
//                (a missing side at distance 2K), clamped to [0, K)
//   syn'       = phase[k] + (syn[nearest] - phase[nearest])
//   out[k]     = (mag[k] cos syn', mag[k] sin syn')
//
// Bound on the card: bytes, three f32 inputs read once and a complex64 output
// written once, 20 B a bin (1024 x 348 x 1025 bins at the pitch shift's size:
// 7.3 GB, 2.18 ms at 3.35 TB/s).
//
// What held the first design back: the full-range sincosf. syn' grows with the
// frame index (a float32 running sum of true_freq x hop, up to 1.05e6 rad at 348
// frames), and above 105,615 rad sincosf takes its Payne-Hanek path through a
// local stack frame; and 40 KB of static shared memory a 4-warp block (20 warps
// an SM).
//
// The design:
// - The rotation reduces syn' (a float32, formed exactly as the plain version
//   forms it: __fsub_rn, then __fadd_rn) by pi/2 in float64: kq = rint(syn' 2/pi),
//   r = syn' - kq pi/2 with pi/2 split into two doubles (the first exact in a
//   product with kq < 2^20), then r to float32, |r| <= pi/4, and a minimax
//   polynomial of each of sin and cos there, the quadrant kq mod 4 choosing the
//   pair and its signs. About six float64 operations a bin; no slow path, no
//   local memory. The spectrum no longer has torch's cos / sin bits: it lies
//   within 2^-22 of float64 cos / sin of the float32 syn' (rounding r to float32
//   and the polynomial, each under 2^-24), times mag.
// - One warp a row, eight rows a block. The row's magnitudes go to shared memory
//   by cp.async (4 B x K a warp, dynamic), the only shared memory: 32.8 KB a
//   block at K = 1025, so shared memory allows 6 blocks (48 warps) an SM.
// - The peaks of 32 bins are one __ballot_sync word; lane s keeps the words of
//   steps s and s + 32 (K <= 1280: 40 steps), and a ballot of the nonzero words
//   finds the next step with a peak. A bin's fills are then a clz / ffs of its
//   step's word masked at its lane, or the last peak of the steps before it
//   (carried) or the first peak of the steps after it: no scans, nothing stored
//   a bin. nearest is the plain version's.
// - syn and phase are read where they are needed: phase[k] coalesced, the
//   gathers syn[nearest] and phase[nearest] from the same lines, through L1.
//
// Measured (NVIDIA H100 80GB HBM3 at a 700 W limit, chip_smoke.py, the first
// design in turns in the same run): on the pitch shift's 356,352 rows of 1025
// bins, 2.9744 ms against 6.3231, 73 % of the byte bound; 40 registers, no
// local memory, 48 warps an SM.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // rows a block
constexpr int THREADS = 32 * WARPS;
constexpr int K_MAX = 1280;  // bins a row at most: 40 steps of 32, two mask words a lane
constexpr unsigned FULL = 0xffffffffu;

// the reduction by pi/2 (fdlibm's __ieee754_rem_pio2 constants): PIO2_HI is pi/2
// to 33 bits, so kq PIO2_HI is exact for |kq| < 2^20; PIO2_LO = pi/2 - PIO2_HI
constexpr double TWO_OVER_PI = 6.36619772367581382433e-01;
constexpr double PIO2_HI = 1.57079632673412561417e+00;
constexpr double PIO2_LO = 6.07710050650619224932e-11;
// sin x = x + x^3 S(x^2), cos x = 1 - x^2 / 2 + x^4 C(x^2) on |x| <= pi/4
constexpr float S0 = -1.6666667e-01f, S1 = 8.333328e-03f, S2 = -1.9839019e-04f,
                S3 = 2.7158228e-06f;
constexpr float C0 = 4.1666668e-02f, C1 = -1.3888883e-03f, C2 = 2.4799492e-05f,
                C3 = -2.7208205e-07f;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src));
}

// (cos s, sin s) of a float32 s of any size, reduced in float64
__device__ __forceinline__ float2 rotation(float s) {
    const double d = (double)s;
    const double kq = rint(__dmul_rn(d, TWO_OVER_PI));
    const double r = __fma_rn(-kq, PIO2_LO, __fma_rn(-kq, PIO2_HI, d));
    const float x = __double2float_rn(r);
    const int q = __double2int_rz(kq) & 3;
    const float z = __fmul_rn(x, x);
    const float ps = __fmaf_rn(__fmaf_rn(__fmaf_rn(S3, z, S2), z, S1), z, S0);
    const float pc = __fmaf_rn(__fmaf_rn(__fmaf_rn(C3, z, C2), z, C1), z, C0);
    const float sr = __fmaf_rn(__fmul_rn(x, z), ps, x);
    const float cr = __fmaf_rn(__fmul_rn(z, z), pc, __fmaf_rn(-0.5f, z, 1.0f));
    const float sv = (q & 1) ? cr : sr;
    const float cv = (q & 1) ? sr : cr;
    return make_float2(((q + 1) & 2) ? -cv : cv, (q & 2) ? -sv : sv);
}

__global__ void __launch_bounds__(THREADS)
phase_lock_kernel(const float* __restrict__ mag, const float* __restrict__ phase,
                  const float* __restrict__ syn, float2* __restrict__ out,
                  int32_t* __restrict__ nearest, int rows, int K) {
    extern __shared__ float s_mag[];
    const int w = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const long long row = (long long)blockIdx.x * WARPS + w;
    if (row >= rows) return;  // the whole warp leaves: only warp-level sync below
    const size_t o = (size_t)row * K;
    float* m = s_mag + w * K;
    for (int k = lane; k < K; k += 32) cp_async4(m + k, mag + o + k);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();

    // the peaks, a ballot word a step of 32 bins
    const int steps = (K + 31) / 32;
    unsigned mA = 0, mB = 0;  // lane s: the words of steps s and s + 32
    for (int j = 0; j < steps; ++j) {
        const int k = j * 32 + lane;
        bool pk = false;
        if (k < K) {
            const float lo = k > 0 ? m[k - 1] : -CUDART_INF_F;
            const float hi = k + 1 < K ? m[k + 1] : -CUDART_INF_F;
            pk = m[k] >= lo && m[k] > hi;
        }
        const unsigned word = __ballot_sync(FULL, pk);
        if (lane == (j & 31)) {
            if (j < 32) mA = word;
            else mB = word;
        }
    }
    const unsigned long long nz = ((unsigned long long)__ballot_sync(FULL, mB != 0) << 32) |
                                  __ballot_sync(FULL, mA != 0);

    const int big = 2 * K;
    int last = -1;  // the last peak of the steps before j
#pragma unroll 2
    for (int j = 0; j < steps; ++j) {
        const unsigned word = __shfl_sync(FULL, j < 32 ? mA : mB, j & 31);
        const unsigned long long later = nz & (~0ull << (j + 1));  // j + 1 <= 40
        int next = big;  // the first peak of the steps after j
        if (later != 0) {
            const int s = __ffsll((long long)later) - 1;
            const unsigned ws = __shfl_sync(FULL, s < 32 ? mA : mB, s & 31);
            next = s * 32 + __ffs(ws) - 1;
        }
        const unsigned below = word & (FULL >> (31 - lane));  // bins j*32 .. k
        const unsigned above = word & (FULL << lane);         // bins k .. j*32 + 31
        const int f = below ? j * 32 + 31 - __clz(below) : last;
        const int v = above ? j * 32 + __ffs(above) - 1 : next;
        if (word) last = j * 32 + 31 - __clz(word);
        const int k = j * 32 + lane;
        if (k < K) {
            const int dist_f = f >= 0 ? k - f : big;
            const int dist_b = v < big ? v - k : big;
            const int nr = min(max(dist_f <= dist_b ? f : v, 0), K - 1);
            const float rot = __fsub_rn(__ldg(syn + o + nr), __ldg(phase + o + nr));
            const float2 cs = rotation(__fadd_rn(__ldg(phase + o + k), rot));
            const float mk = m[k];
            out[o + k] = make_float2(__fmul_rn(mk, cs.x), __fmul_rn(mk, cs.y));
            if (nearest != nullptr) nearest[o + k] = nr;
        }
    }
}

}  // namespace

extern "C" int skt_phase_lock(const float* mag, const float* phase, const float* syn,
                              void* out, int32_t* nearest, int rows, int K, void* stream) {
    if (rows <= 0) return 0;
    if (K <= 0 || K > K_MAX) return (int)cudaErrorInvalidValue;
    const size_t shared = (size_t)WARPS * K * sizeof(float);
    static bool sized = false;
    if (!sized) {
        const cudaError_t e = cudaFuncSetAttribute(
            phase_lock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)(WARPS * K_MAX * sizeof(float)));
        if (e != cudaSuccess) return (int)e;
        sized = true;
    }
    const unsigned grid = (unsigned)((rows + WARPS - 1) / WARPS);
    phase_lock_kernel<<<grid, THREADS, shared, (cudaStream_t)stream>>>(
        mag, phase, syn, static_cast<float2*>(out), nearest, rows, K);
    return (int)cudaGetLastError();
}

// out[0] registers a thread, out[1] local (spilled) bytes a thread, out[2] dynamic
// shared bytes a block at K bins, out[3] resident blocks an SM (warps: x WARPS)
extern "C" int skt_phase_lock_occupancy(int K, int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, phase_lock_kernel);
    const size_t shared = (size_t)WARPS * K * sizeof(float);
    int per_sm = 0;
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(phase_lock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)(WARPS * K_MAX * sizeof(float)));
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, phase_lock_kernel, THREADS,
                                                          shared);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)shared;
    out[3] = per_sm;
    return 0;
}
