// K13: the window, shift, overlap-add, new lap and masks of one lockstep Vorbis
// packet for every lane: soundkit_tpu/ops/vorbis_batch.py::_vorbis_synth_step
// after its two IMDCT matmuls (XLA there, no Pallas kernel).
//
// Inputs: the long IMDCT output pcm1 [B, C, n1] and the short one pcm0 [B, C, n0]
// (read at its own width), the window bank [5, n1], the lane flags int32 [5, B]
// (block flag, previous and next window flags, validity, previous block's flag)
// and the carried lap carry [B, C, n1/2]. Outputs: out and new_carry [B, C, n1/2].
//
// One thread a float4 of samples j .. j+3 of a (lane, channel) row; a block
// covers 4 x THREADS samples of one row, so the grid is rows x ceil(n1/2 / (4 x
// THREADS)) and needs no shared memory whatever n1 is (up to 8192). With n the
// block's size, d = prev_n/4 + n/4 and the shift s (0 when the sizes agree,
// +(n1-n0)/4 after a long block, -(n1-n0)/4 before one), the windowed, shifted
// block is q[k] = pcm[k-s] * w[k-s] (zero where k-s leaves [0, n1), pcm zero past
// n) and buf[k] = carry[k] + q[k] (the carry zero past n1/2). A thread writes
// out[j] = buf[j] and new_carry[j] = buf[d+j] where j < n/2, else 0; a lane that
// is not valid writes zero PCM and its carry unchanged. Block sizes are powers of
// two >= 64 in Vorbis, so s, d, n/2 and the row strides are multiples of 4 (the
// wrapper checks it) and every float4 lies wholly inside or outside each range.
// Each product and sum is rounded alone (__fmul_rn, __fadd_rn: no FMA), in the
// reference's order, so the result is bit-exact against the plain version.
//
// Bound on the card: bytes. Each valid lane reads its block's IMDCT output once
// (n1 or n0 samples), every lane its carry, and writes out and the new carry; the
// window bank (5 rows) stays in the caches.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int V = 4;  // samples a thread
enum { F_N = 0, F_PREV, F_NEXT, F_VALID, F_CFLAG };

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
    return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                       __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                       __fadd_rn(a.w, b.w));
}

__global__ void __launch_bounds__(THREADS)
vorbis_overlap_kernel(const float* __restrict__ pcm1, const float* __restrict__ pcm0,
                      const float* __restrict__ bank, const int32_t* __restrict__ flags,
                      const float* __restrict__ carry, float* __restrict__ out,
                      float* __restrict__ new_carry, int B, int C, int n0, int n1) {
    const int row = blockIdx.x;  // b * C + c
    const int b = row / C;
    const int h1 = n1 / 2;
    const int j = V * (blockIdx.y * THREADS + threadIdx.x);
    if (j >= h1) return;
    const size_t o = (size_t)row * h1 + j;
    const float* cr = carry + (size_t)row * h1;
    if (!flags[F_VALID * B + b]) {
        reinterpret_cast<float4*>(out)[o / V] = zero4();
        reinterpret_cast<float4*>(new_carry)[o / V] = *reinterpret_cast<const float4*>(cr + j);
        return;
    }
    const bool cur_long = flags[F_N * B + b] == 1;
    const bool prev_long = flags[F_CFLAG * B + b] == 1;
    const int widx = cur_long ? flags[F_PREV * B + b] * 2 + flags[F_NEXT * B + b] : 4;
    const int sL = (n1 - n0) / 4;
    const int s = prev_long == cur_long ? 0 : (prev_long ? sL : -sL);
    const int n = cur_long ? n1 : n0;
    const int d = (prev_long ? n1 : n0) / 4 + n / 4;
    const float* x = cur_long ? pcm1 + (size_t)row * n1 : pcm0 + (size_t)row * n0;
    const float* w = bank + (size_t)widx * n1;

    // q[k .. k+3]: the windowed block shifted by s (k - s and n multiples of 4)
    auto shifted = [&](int k) -> float4 {
        const int i = k - s;
        if (i < 0 || i >= n1) return zero4();
        const float4 v = i < n ? __ldg(reinterpret_cast<const float4*>(x + i)) : zero4();
        return mul4(v, __ldg(reinterpret_cast<const float4*>(w + i)));
    };

    const float4 c = *reinterpret_cast<const float4*>(cr + j);
    reinterpret_cast<float4*>(out)[o / V] = add4(c, shifted(j));
    float4 nc = zero4();
    if (j < n / 2) {
        const int k = d + j;
        const float4 c0 = k < h1 ? *reinterpret_cast<const float4*>(cr + k) : zero4();
        nc = add4(c0, shifted(k));
    }
    reinterpret_cast<float4*>(new_carry)[o / V] = nc;
}

}  // namespace

extern "C" int skt_vorbis_overlap(const float* pcm1, const float* pcm0, const float* bank,
                                  const int32_t* flags, const float* carry, float* out,
                                  float* new_carry, int B, int C, int n0, int n1, void* stream) {
    if (B <= 0 || C <= 0) return 0;
    if (n0 < 64 || n1 < n0 || n0 % 16 || n1 % 16) return (int)cudaErrorInvalidValue;
    const int per_block = V * THREADS;
    const dim3 grid((unsigned)(B * C), (unsigned)((n1 / 2 + per_block - 1) / per_block));
    vorbis_overlap_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        pcm1, pcm0, bank, flags, carry, out, new_carry, B, C, n0, n1);
    return (int)cudaGetLastError();
}
