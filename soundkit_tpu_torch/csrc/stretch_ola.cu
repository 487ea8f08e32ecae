// K16: the overlap-add and window-square normalisation of the device phase
// vocoder: soundkit_tpu/ops/stretch.py::stretch_batch_device, the `* win` of the
// synthesis frames, the lax.scan `ola` of dynamic_update_slice adds, the divide
// by max(norm, 1e-8) and the crop to [FRAME/2, FRAME/2 + target) with its zero
// pad (XLA there, no Pallas kernel).
//
// Inputs: the synthesis frames f32 [B, T, F] (irfft output, before the window)
// and the window f32 [F]; den f32 [target] is scratch. Output: out f32 [B,
// target]. The divisor max(sum_t win^2[J - t hop], 1e-8) at J = start + j does
// not depend on the lane: a first launch builds it once a call into den, in the
// scan's order (each square rounded, the sum in ascending t), for the second.
//
// One thread an output sample j of one lane, in the crop window only:
//   out[b, j] = (sum over the frames t that cover J = start + j, ascending t,
//                of win[J - t hop] * frame[b, t, J - t hop]) / den[j]
// and 0 where J is past the scan's line (hop (T-1) + F). The sum starts at zero
// and adds each product in ascending frame order, every product and sum rounded
// alone (__fmul_rn, __fadd_rn; no FMA), the divide IEEE (__fdiv_rn): the scan's
// order of operations, so the result equals the plain version bit for bit.
// Neighbouring threads read neighbouring samples of a frame (coalesced); a
// sample reads ceil(F / hop) frames at most (3 at hop 960).
//
// Bound on the card: bytes, each frame that covers the crop window read once
// and the output written once (1024 lanes x 174 of 348 frames x 2048 x 4 B in
// and 1024 x 165375 x 4 B out at the pitch shift's size: 2.14 GB, 0.64 ms at
// 3.35 TB/s).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// the frames t that cover line sample J: t_lo .. t_hi, ascending. The line is
// shorter than 2^31 samples (the wrapper checks it), so the index arithmetic is
// 32-bit: a 64-bit division is a long emulated sequence, a 32-bit one a few
// instructions.
__device__ __forceinline__ void cover(int J, int T, int F, int hop, int* t_lo, int* t_hi) {
    *t_hi = min(J / hop, T - 1);
    *t_lo = J >= F ? (J - F) / hop + 1 : 0;
}

__global__ void __launch_bounds__(THREADS)
stretch_norm_kernel(const float* __restrict__ win, float* __restrict__ den, int T, int F,
                    int hop, int start, int target) {
    const int j = blockIdx.x * THREADS + threadIdx.x;
    if (j >= target) return;
    const int J = start + j;
    if (J >= hop * (T - 1) + F) {
        den[j] = 1.f;  // past the line: the output there is 0
        return;
    }
    int t_lo, t_hi;
    cover(J, T, F, hop, &t_lo, &t_hi);
    float acc = 0.f;
    for (int t = t_lo; t <= t_hi; ++t) {
        const float w = __ldg(win + (J - t * hop));
        acc = __fadd_rn(acc, __fmul_rn(w, w));
    }
    den[j] = fmaxf(acc, 1e-8f);
}

__global__ void __launch_bounds__(THREADS)
stretch_ola_kernel(const float* __restrict__ frames, const float* __restrict__ win,
                   const float* __restrict__ den, float* __restrict__ out, int T, int F,
                   int hop, int start, int target) {
    const int b = blockIdx.y;
    const int j = blockIdx.x * THREADS + threadIdx.x;
    if (j >= target) return;
    const int J = start + j;
    float* o = out + (size_t)b * target + j;
    if (J >= hop * (T - 1) + F) {
        *o = 0.f;
        return;
    }
    int t_lo, t_hi;
    cover(J, T, F, hop, &t_lo, &t_hi);
    const float* fb = frames + (size_t)b * T * F;
    float acc = 0.f;
    for (int t = t_lo; t <= t_hi; ++t) {
        const int i = J - t * hop;
        acc = __fadd_rn(acc, __fmul_rn(__ldg(win + i), __ldg(fb + (size_t)t * F + i)));
    }
    *o = __fdiv_rn(acc, __ldg(den + j));
}

}  // namespace

extern "C" int skt_stretch_ola(const float* frames, const float* win, float* den, float* out,
                               int B, int T, int F, int hop, int start, int target,
                               void* stream) {
    if (B <= 0 || target <= 0) return 0;
    if (T <= 0 || F <= 0 || hop <= 0 || start < 0 ||
        (long long)hop * (T - 1) + F >= (1LL << 31) || (long long)start + target >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const unsigned tiles = (unsigned)((target + THREADS - 1) / THREADS);
    stretch_norm_kernel<<<tiles, THREADS, 0, (cudaStream_t)stream>>>(win, den, T, F, hop, start,
                                                                     target);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const dim3 grid(tiles, (unsigned)B);
    stretch_ola_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(frames, win, den, out, T, F,
                                                                   hop, start, target);
    return (int)cudaGetLastError();
}
