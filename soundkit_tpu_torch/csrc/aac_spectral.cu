// AAC spectral Huffman decode from raw access-unit bytes.
//
// Replaces soundkit_tpu/ops/aac_entropy.py::aac_spectral_decode_device, a
// lax.while_loop/scan that decodes one codeword on every lane per step.
// Each channel lane walks its section program (runs of codebook,
// codeword count, output base): per codeword one 16-bit-prefix lookup in
// the flat [11, 65536] LUT, the sign bits of unsigned codebooks, the
// codebook-11 escapes, and up to four stores into quant[lane, 0:1024].
//
// What bounds it: latency. A codeword's bit position depends on the
// previous codeword's length, so each lane is one dependent chain of
// ~300-1000 steps, each a LUT load (the 2.75 MB table stays resident in
// the 50 MB L2) plus AU byte loads. Design: one thread per channel lane,
// running its own loop to its own end. There is no step budget shared by
// the batch (the reference buckets a static max_steps), and the two
// channel lanes of an AU read the same AU row (lane >> 1) instead of a
// duplicated word array. Every detail of the reference is mirrored for
// bit-exactness: the % W wrap of 32-bit window reads, min(clz(~w), 24)
// for the escape prefix, sign bits only for unsigned codebooks, the
// codebook clamped to 1..11 as the reference's gathers clamp it, and
// stores at positions >= 1024 dropped. The output must be zero-filled by
// the caller.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int N_LINES = 1024;
constexpr int LUT_BITS = 16;
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t au_word(const uint8_t* __restrict__ bytes,
                                            int wi, int W) {
    const uint8_t* p = bytes + (wi % W) * 4;
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

// next 32 bits MSB-first at bit position bp
__device__ __forceinline__ uint32_t window32(const uint8_t* __restrict__ bytes,
                                             int bp, int W) {
    const int wi = bp >> 5;
    const uint32_t sh = (uint32_t)bp & 31u;
    const uint32_t w0 = au_word(bytes, wi, W);
    if (sh == 0) return w0;
    return (w0 << sh) | (au_word(bytes, wi + 1, W) >> (32u - sh));
}

__global__ void __launch_bounds__(THREADS) spectral_decode_kernel(
    const uint8_t* __restrict__ au, int au_stride,
    const int32_t* __restrict__ bitpos0, const int32_t* __restrict__ runs,
    int run_cols, const int32_t* __restrict__ n_runs,
    const int32_t* __restrict__ lut, int32_t* __restrict__ quant, int lanes) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= lanes) return;
    const uint8_t* bytes = au + (long)(l >> 1) * au_stride;
    const int W = au_stride / 4;
    const int32_t* rr = runs + (long)l * run_cols;
    int32_t* q = quant + (long)l * N_LINES;

    int bitpos = bitpos0[l];
    const int nr = n_runs[l];
    int run_i = 0;
    int cw_i = 0;
    while (run_i < nr) {
        const uint32_t r = (uint32_t)rr[min(run_i, run_cols - 1)];
        const int cb = min(max((int)(r & 15u), 1), 11);
        const int ncw = (int)((r >> 4) & 63u);
        const int base = (int)((r >> 10) & 4095u);
        const int dim = cb < 5 ? 4 : 2;
        const bool is_signed = cb <= 2 || cb == 5 || cb == 6;

        // codeword
        const uint32_t win = window32(bytes, bitpos, W);
        const int32_t entry =
            __ldg(lut + (long)(cb - 1) * (1 << LUT_BITS) + (win >> (32 - LUT_BITS)));
        int vals[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            vals[i] = i < dim ? ((entry >> (5 + 6 * i)) & 63) - 16 : 0;
        bitpos += entry & 31;

        // sign bits (unsigned codebooks), one per nonzero value, in order
        if (!is_signed) {
            const uint32_t swin = window32(bytes, bitpos, W);
            int before = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (i < dim && vals[i] != 0) {
                    if ((swin >> (31 - before)) & 1u) vals[i] = -vals[i];
                    ++before;
                }
            }
            bitpos += before;
        }

        // codebook-11 escapes, value 0 then value 1
        if (cb == 11) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (abs(vals[i]) != 16) continue;
                const uint32_t ewin = window32(bytes, bitpos, W);
                const int n1 = min(__clz((int)~ewin), 24);
                const int n = 4 + n1;
                const int bpe = bitpos + n1 + 1;
                const uint32_t mant = window32(bytes, bpe, W) >> (32 - n);
                const int mag = (1 << n) | (int)mant;
                vals[i] = vals[i] < 0 ? -mag : mag;
                bitpos = bpe + n;
            }
        }

        const int pos = base + cw_i * dim;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (i < dim && pos + i < N_LINES) q[pos + i] = vals[i];

        if (++cw_i >= ncw) {
            ++run_i;
            cw_i = 0;
        }
    }
}

}  // namespace

extern "C" int skt_spectral_decode(const uint8_t* au, int au_stride,
                                   const int32_t* bitpos, const int32_t* runs,
                                   int run_cols, const int32_t* n_runs,
                                   const int32_t* lut, int32_t* quant, int lanes,
                                   void* stream) {
    const int blocks = (lanes + THREADS - 1) / THREADS;
    spectral_decode_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        au, au_stride, bitpos, runs, run_cols, n_runs, lut, quant, lanes);
    return (int)cudaGetLastError();
}
