// K15: the polyphase FIR of the windowed-sinc resampler, one-shot and with a
// carried input history: soundkit_tpu/ops/resample.py::resample and
// ::resample_stateful (one lax.conv_general_dilated of stride M with L output
// channels at Precision.HIGHEST there; XLA, no Pallas kernel).
//
//   y[b, c L + p] = sum_{q < 256} taps[q, p] * xpad[b, c M + off[p] + q]
//
// xpad is the 255 samples of history (hist, or zeros when hist is null), then
// the row of x, then zeros. taps is the bank transposed to [256, L] (taps[q, p]
// = taps_rev[p, q]), off[p] = floor(p M / L) < M.
//
// A block takes CT cycles (CT L outputs) of one row: it stages the inputs they
// read, CT M + 255 samples from xpad[c0 M], in shared memory (the wrapper keeps
// that under 48 KB), then each thread sums R = CYCLES_PER_THREAD outputs of one
// phase p at cycles c0 + g + r CT/R (r < R): one tap load feeds R products, and
// neighbouring threads take neighbouring phases (coalesced taps) or, for L < 32,
// cycles M samples apart (odd M: no bank conflicts). Taps are read through the
// read-only cache (__ldg): the bank is L x 1 KB, 80 KB at 44.1 -> 8 kHz and 441
// KB at 8 -> 44.1 kHz, over the shared memory an SM has, and every block of the
// grid reads the same bank, so it stays in L2.
//
// Every output sums its taps in the order q = 0 .. 255, each step one fmaf, from
// an accumulator at zero: its bits depend only on its 256 inputs and the taps,
// so a chunked run with the true history equals the one-shot run bit for bit.
//
// Bound on the card: operations, 2 x 256 flops an output (1024 x 5120 outputs a
// chunk of the transcode chain: 2.68 GFLOP, 0.040 ms at 67 TFLOP/s, against
// 138 MB of input and output, 0.041 ms at 3.35 TB/s). Each fmaf takes one
// shared load beside it, so the shared-memory pipe, 32 loads a clock an SM
// against 128 fmaf, holds this design to about a quarter of the float32 rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int S = 256;  // taps a phase (SINC_LEN)
constexpr int R = 4;    // cycles a thread sums (CYCLES_PER_THREAD)

__global__ void __launch_bounds__(THREADS)
resample_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                const float* __restrict__ taps, const int32_t* __restrict__ offsets,
                float* __restrict__ out, int n, int L, int M, int n_out, int ct) {
    extern __shared__ float xs[];
    const int b = blockIdx.y;
    const int c0 = blockIdx.x * ct;
    const long long base = (long long)c0 * M;  // xpad index of xs[0]
    const int span = ct * M + S - 1;
    const float* xb = x + (size_t)b * n;
    const float* hb = hist == nullptr ? nullptr : hist + (size_t)b * (S - 1);
    for (int i = threadIdx.x; i < span; i += THREADS) {
        const long long j = base + i;
        float v = 0.f;
        if (j < S - 1) {
            if (hb != nullptr) v = hb[j];
        } else if (j - (S - 1) < n) {
            v = __ldg(xb + (j - (S - 1)));
        }
        xs[i] = v;
    }
    __syncthreads();

    const int G = ct / R;  // ct is a multiple of R
    const int items = L * G;
    float* ob = out + (size_t)b * n_out;
    for (int it = threadIdx.x; it < items; it += THREADS) {
        const int p = it % L;
        const int g = it / L;
        const float* xp = xs + g * M + __ldg(offsets + p);
        const float* tp = taps + p;
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 8
        for (int q = 0; q < S; ++q) {
            const float t = __ldg(tp + (size_t)q * L);
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] = fmaf(t, xp[r * G * M + q], acc[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const long long k = (long long)(c0 + g + r * G) * L + p;
            if (k < n_out) ob[k] = acc[r];
        }
    }
}

}  // namespace

extern "C" int skt_resample(const float* x, const float* hist, const float* taps,
                            const int32_t* offsets, float* out, int B, int n, int L, int M,
                            int n_out, int ct, void* stream) {
    if (B <= 0 || n_out <= 0) return 0;
    if (L <= 0 || M <= 0 || ct <= 0 || ct % R) return (int)cudaErrorInvalidValue;
    const size_t shared = (size_t)(ct * M + S - 1) * sizeof(float);
    if (shared > 48 * 1024) return (int)cudaErrorInvalidValue;
    const int n_cycles = (n_out + L - 1) / L;
    const dim3 grid((unsigned)((n_cycles + ct - 1) / ct), (unsigned)B);
    resample_kernel<<<grid, THREADS, shared, (cudaStream_t)stream>>>(
        x, hist, taps, offsets, out, n, L, M, n_out, ct);
    return (int)cudaGetLastError();
}
