// K17: the identity phase locking and resynthesis of the device phase vocoder:
// soundkit_tpu/ops/stretch.py::stretch_batch_device, the peak test, the
// lax.cummax forward fill and lax.cummin backward fill of peak indices, the
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
// One warp a row: it stages the row's magnitudes in shared memory, then walks
// the row in 32-bin steps, the forward fill as a warp max-scan (shfl_up) with the
// previous step's last value carried, the backward fill from the top as a min-scan
// (shfl_down) carrying the next step's first value, so each bin's two fills are
// the plain version's and nearest is identical. The subtraction and the add are
// rounded alone (__fsub_rn, __fadd_rn) in the reference's order, so syn' has the
// plain version's bits. syn' grows with the frame index (a float32 running sum of
// true_freq x hop over the frames, 1e5-1e6 rad at 348 frames), so the rotation is
// the full-range sincosf (no fast-math, no __sinf / __cosf).
//
// Bound on the card: bytes, three f32 inputs read once and a complex64 output
// written once, 20 B a bin (1024 x 348 x 1025 bins at the pitch shift's size:
// 7.3 GB, 2.18 ms at 3.35 TB/s).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // rows a block
constexpr int THREADS = 32 * WARPS;
constexpr int K_MAX = 1280;  // bins a row at most (the shared memory below)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool is_peak(const float* m, int k, int K) {
    const float lo = k > 0 ? m[k - 1] : -CUDART_INF_F;
    const float hi = k + 1 < K ? m[k + 1] : -CUDART_INF_F;
    return m[k] >= lo && m[k] > hi;
}

__global__ void __launch_bounds__(THREADS)
phase_lock_kernel(const float* __restrict__ mag, const float* __restrict__ phase,
                  const float* __restrict__ syn, float2* __restrict__ out,
                  int32_t* __restrict__ nearest, int rows, int K) {
    __shared__ float s_mag[WARPS][K_MAX];
    __shared__ int s_ff[WARPS][K_MAX];
    const int w = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const long long row = (long long)blockIdx.x * WARPS + w;
    if (row >= rows) return;  // the whole warp leaves: only __syncwarp below
    const size_t o = (size_t)row * K;
    float* m = s_mag[w];
    int* ff = s_ff[w];
    for (int k = lane; k < K; k += 32) m[k] = __ldg(mag + o + k);
    __syncwarp();

    int carry = -1;
    for (int base = 0; base < K; base += 32) {
        const int k = base + lane;
        int v = k < K && is_peak(m, k, K) ? k : -1;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int u = __shfl_up_sync(FULL, v, d);
            if (lane >= d) v = max(v, u);
        }
        v = max(v, carry);
        if (k < K) ff[k] = v;
        carry = __shfl_sync(FULL, v, 31);
    }
    __syncwarp();

    const int big = 2 * K;
    carry = big;
    for (int base = (K - 1) / 32 * 32; base >= 0; base -= 32) {
        const int k = base + lane;
        int v = k < K && is_peak(m, k, K) ? k : big;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int u = __shfl_down_sync(FULL, v, d);
            if (lane + d < 32) v = min(v, u);
        }
        v = min(v, carry);
        carry = __shfl_sync(FULL, v, 0);
        if (k < K) {
            const int f = ff[k];
            const int dist_f = f >= 0 ? k - f : big;
            const int dist_b = v < big ? v - k : big;
            const int nr = min(max(dist_f <= dist_b ? f : v, 0), K - 1);
            const float rot = __fsub_rn(__ldg(syn + o + nr), __ldg(phase + o + nr));
            const float s = __fadd_rn(__ldg(phase + o + k), rot);
            float sn, cs;
            sincosf(s, &sn, &cs);
            out[o + k] = make_float2(__fmul_rn(m[k], cs), __fmul_rn(m[k], sn));
            if (nearest != nullptr) nearest[o + k] = nr;
        }
    }
}

}  // namespace

extern "C" int skt_phase_lock(const float* mag, const float* phase, const float* syn,
                              void* out, int32_t* nearest, int rows, int K, void* stream) {
    if (rows <= 0) return 0;
    if (K <= 0 || K > K_MAX) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((rows + WARPS - 1) / WARPS);
    phase_lock_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        mag, phase, syn, static_cast<float2*>(out), nearest, rows, K);
    return (int)cudaGetLastError();
}
