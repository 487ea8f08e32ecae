// K15: the polyphase FIR of the windowed-sinc resampler, one-shot and with a
// carried input history: soundkit_tpu/ops/resample.py::resample and
// ::resample_stateful (:154-162, :199-204: one lax.conv_general_dilated of
// stride M with L output channels at Precision.HIGHEST there; XLA, no Pallas
// kernel).
//
//   y[b, c L + p] = sum_{q < 256} taps[q, p] * xpad[b, c M + off[p] + q]
//
// xpad is the 255 samples of history (hist, or zeros when hist is null), then
// the row of x, then zeros; off[p] = floor(p M / L) < M.
//
// Bound on the card: operations, 2 x 256 flops an output (1024 x 5120 outputs
// a chunk of the transcode chain: 2.68 GFLOP, 0.040 ms at 67 TFLOP/s, against
// 138 MB of input and output, 0.041 ms at 3.35 TB/s; the pitch shift's 1024 x
// 110,250 outputs: 57.8 GFLOP, 0.86 ms).
//
// What held the first design back: one shared load beside every fmaf (a
// thread summed one phase at 4 cycles, each product reading its own input),
// and the shared-memory pipe issues a quarter of the float32 rate.
//
// The design: a register-tiled banded product. The host (ops/resample.py
// band_bank) takes g cycles as one super-cycle (g = 8 / gcd(L, 8) for L < 16,
// else 1): Lq = g L phases from Mq = g M inputs, super-phase r L + p at offset
// r M + off[p]. Groups of 8 consecutive super-phases share one band: from the
// group's first offset, W[k, j, i] = taps[j - d_i, p_i] (zero outside the
// phase's 256 taps), j < 256 + d_7, so that
//   y[c Lq + 8k + i] = sum_j W[k, j, i] * xpad[c Mq + base_k + j].
// A warp takes one group and 32 RC super-cycles of one row, lane t the
// super-cycles t + 32 r (r < RC). For each j a thread reads RC inputs and the
// group's 8 band values (two float4 loads that every lane of the warp shares)
// and issues 8 RC fmafs: RC + 2 loads for 8 RC products, against 5 loads for 4
// products before. A persistent block walks the (row, tile) pairs of one chunk
// of groups: it stages the chunk's bank rows in shared memory once (where they
// fit beside a tile; else they come through L1), and each tile's input span by
// 4-byte cp.async, all of it in flight at once, Mq words a super-cycle, padded
// to an odd pitch where Mq is even, so that the 32 lanes (one super-cycle
// apart) read 32 banks; then its accumulators go through shared memory so that
// the row's outputs leave in coalesced stores. ops/resample.py k15_plan picks
// RC, the slabs of 32 RC super-cycles a block and the staging of the bank.
//
// The bits are kept. Each output still sums its 256 taps in the order q = 0
// .. 255, one fmaf a step, from an accumulator at +0; the band's zeros add
// products 0 x xpad, which leave a finite sum as it was (an accumulator at +0
// stays +0). So a chunked run with the true history equals the one-shot run bit
// for bit, and both equal cuDNN's IEEE convolution, as the first design did.
// (A non-finite input reaches one band further than the 256 taps, as it does
// in a convolution over the embedded bank.)
//
// Measured (NVIDIA H100 80GB HBM3 at a 700 W limit, chip_smoke.py, the first
// design in turns in the same run): the transcode chunk 0.2137 ms against
// 0.4672, its 94 KB bank and 114 KB span leaving one block (10 warps) an SM;
// the stretch resample 2.0495 ms against 7.8406, 42 % of the float32 rate.
// What holds it now: the loads beside the fmafs (a band read from shared memory
// beats one through L1 by 15-20 %; more accumulators a thread, reads a step
// ahead or float4 input reads took more registers and fewer warps, and lost).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int S = 256;           // taps a phase (SINC_LEN)
constexpr int P = 8;             // phases a group (GROUP_PHASES)
constexpr int MAX_THREADS = 512;  // 16 warps (MAX_WARPS)

// threads a block at RC super-cycles a thread (ops/resample.py max_warps): 64
// accumulators at RC = 8 take up to 255 registers, so 8 warps
__host__ __device__ constexpr int max_threads(int rc) { return rc == 8 ? MAX_THREADS / 2 : MAX_THREADS; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src));
}

// 4 bytes global -> shared without a register round trip; bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src), "r"(bytes));
}

template <int RC, bool WS>
__global__ void __launch_bounds__(max_threads(RC))
resample_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                const float4* __restrict__ bank, const int2* __restrict__ meta,
                float* __restrict__ out, int B, int n, int Lq, int Mq, int pitch, int n_out,
                int G, int band_max, int GB, int chunks, int smem_words) {
    extern __shared__ float sm[];
    const int warps = blockDim.x / 32;
    const int ct = warps / GB * 32 * RC;  // super-cycles a tile
    const int ncp = (n_out + Lq - 1) / Lq;
    const int tiles = (ncp + ct - 1) / ct;
    // a block keeps one chunk of groups (gridDim.x is a multiple of chunks) and
    // walks the (row, tile) pairs of that chunk
    const int g0 = (int)(blockIdx.x % chunks) * GB;
    const int gn = min(GB, G - g0);
    const int lo = __ldg(&meta[g0].x);
    const int2 top = __ldg(&meta[g0 + gn - 1]);
    const int span = (ct - 1) * Mq + top.x + top.y - lo;
    const bool padded = pitch != Mq;
    const int wofs = WS ? smem_words - GB * band_max * 8 : 0;  // the bank rows' first word
    if (WS) {  // the chunk's bank rows after the tile, once a block, 16 bytes a copy
        const float4* src = bank + (size_t)g0 * band_max * 2;
        float4* dst = reinterpret_cast<float4*>(sm + wofs);
        for (int i = threadIdx.x; i < gn * band_max * 2; i += blockDim.x) cp_async16(dst + i, src + i);
    }
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int gi = warp % GB;
    const int u0 = warp / GB * 32 * RC;  // the warp's first super-cycle in a tile
    const int opitch = GB * P + 4;  // words a super-cycle of outputs (16-byte rows, no conflicts)
    const int width = gn * P;
    // u = f / width by a float reciprocal: f < 2^16 and u < 2^12, so the product is
    // within 2^-11 of (f + 0.5) / width, whose distance to an integer is at least
    // 0.5 / width >= 2^-8
    const float inv = 1.0f / (float)width;
    const long long p0 = (long long)g0 * P;

    for (long long item = blockIdx.x / chunks; item < (long long)tiles * B;
         item += gridDim.x / chunks) {
        const int b = (int)(item / tiles);
        const long long c0 = (item % tiles) * ct;

        // the tile's inputs: xpad[c0 Mq + lo ..], element s at s + s / Mq where
        // padded, every word by cp.async, so that the whole span is in flight at once
        {
            const long long e0 = c0 * Mq + lo - (S - 1);  // x index of element 0
            const float* xb = x + (size_t)b * n;
            const float* hb = hist == nullptr ? nullptr : hist + (size_t)b * (S - 1);
            const int step_q = padded ? (int)blockDim.x / Mq : 0;
            const int step_r = padded ? (int)blockDim.x % Mq : 0;
            int q = padded ? (int)threadIdx.x / Mq : 0;  // s / Mq, carried
            int r = padded ? (int)threadIdx.x % Mq : 0;
            for (int s = threadIdx.x; s < span; s += blockDim.x) {
                const long long e = e0 + s;
                const float* src = xb;
                int bytes = 0;
                if (e < 0) {
                    if (hb != nullptr) src = hb + (e + (S - 1)), bytes = 4;
                } else if (e < n) {
                    src = xb + e, bytes = 4;
                }
                cp_async4(sm + s + q, src, bytes);
                q += step_q;
                r += step_r;
                if (r >= Mq && padded) r -= Mq, ++q;
            }
            asm volatile("cp.async.wait_all;\n" ::: "memory");
        }
        __syncthreads();

        float acc[RC][P];
#pragma unroll
        for (int r = 0; r < RC; ++r)
#pragma unroll
            for (int i = 0; i < P; ++i) acc[r][i] = 0.f;
        if (gi < gn && c0 + u0 < ncp) {
            const int2 gm = __ldg(&meta[g0 + gi]);
            const int base = gm.x - lo;
            const int band = gm.y;
            const int rs = 32 * pitch;
            const float4* wp = WS ? reinterpret_cast<const float4*>(sm + wofs) + gi * band_max * 2
                                  : bank + (size_t)(g0 + gi) * band_max * 2;
            const float* xp = sm + (u0 + lane) * pitch + base + (padded ? base / Mq : 0);
            int j = 0;
            int stop = padded ? Mq - base % Mq : band;  // where a pad word is skipped
            for (;;) {
                stop = min(stop, band);
#pragma unroll 4
                for (; j < stop; ++j) {
                    const float4 wa = WS ? wp[2 * j] : __ldg(wp + 2 * j);
                    const float4 wb = WS ? wp[2 * j + 1] : __ldg(wp + 2 * j + 1);
                    const float w[P] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
                    for (int r = 0; r < RC; ++r) {
                        const float v = xp[r * rs];
#pragma unroll
                        for (int i = 0; i < P; ++i) acc[r][i] = __fmaf_rn(w[i], v, acc[r][i]);
                    }
                    ++xp;
                }
                if (j >= band) break;
                ++xp;
                stop = j + Mq;
            }
        }
        __syncthreads();  // the span is read: the tile's outputs take its place

        if (gi < gn) {
#pragma unroll
            for (int r = 0; r < RC; ++r) {
                float4* dst = reinterpret_cast<float4*>(sm + (u0 + lane + 32 * r) * opitch + gi * P);
                dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
                dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
            }
        }
        __syncthreads();
        // the block's outputs of super-cycle u are y[(c0 + u) Lq + g0 P + i], i < gn P:
        // one float a thread, consecutive threads on consecutive outputs
        float* ob = out + (size_t)b * n_out;
        for (int f = threadIdx.x; f < ct * width; f += blockDim.x) {
            const int u = (int)(((float)f + 0.5f) * inv);
            const int i = f - u * width;
            const long long p = p0 + i;
            const long long k = (c0 + u) * Lq + p;
            if (p < Lq && k < n_out) ob[k] = sm[u * opitch + i];
        }
        __syncthreads();  // the tile is written: the next span takes its place
    }
}

template <int RC, bool WS>
int launch(const float* x, const float* hist, const float4* bank, const int2* meta, float* out,
           int B, int n, int Lq, int Mq, int pitch, int n_out, int G, int band_max, int GB,
           int slabs, int smem, cudaStream_t stream) {
    static bool sized = false;
    if (!sized) {
        const cudaError_t e = cudaFuncSetAttribute(
            resample_kernel<RC, WS>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
        if (e != cudaSuccess) return (int)e;
        sized = true;
    }
    const int threads = 32 * slabs * GB;
    if (threads > max_threads(RC)) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resample_kernel<RC, WS>, threads,
                                                          smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
    const long long ncp = (n_out + Lq - 1) / Lq;
    const long long ct = (long long)slabs * 32 * RC;
    const int chunks = (G + GB - 1) / GB;
    const long long items = (ncp + ct - 1) / ct * B;  // (row, tile) pairs of a chunk
    // a persistent grid: the SMs' resident blocks, a multiple of chunks
    const long long per_chunk = std::min<long long>(items, std::max(1, sms * per_sm / chunks));
    resample_kernel<RC, WS><<<(unsigned)(per_chunk * chunks), threads, smem, stream>>>(
        x, hist, bank, meta, out, B, n, Lq, Mq, pitch, n_out, G, band_max, GB, chunks, smem / 4);
    return (int)cudaGetLastError();
}

template <bool WS>
int dispatch(int RC, const float* x, const float* hist, const float4* w, const int2* m,
             float* out, int B, int n, int Lq, int Mq, int pitch, int n_out, int G, int band_max,
             int GB, int slabs, int smem, cudaStream_t s) {
    switch (RC) {
        case 1: return launch<1, WS>(x, hist, w, m, out, B, n, Lq, Mq, pitch, n_out, G, band_max, GB, slabs, smem, s);
        case 2: return launch<2, WS>(x, hist, w, m, out, B, n, Lq, Mq, pitch, n_out, G, band_max, GB, slabs, smem, s);
        case 4: return launch<4, WS>(x, hist, w, m, out, B, n, Lq, Mq, pitch, n_out, G, band_max, GB, slabs, smem, s);
        case 8: return launch<8, WS>(x, hist, w, m, out, B, n, Lq, Mq, pitch, n_out, G, band_max, GB, slabs, smem, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <bool WS>
const void* kernel_of(int RC) {
    return RC == 1   ? (const void*)resample_kernel<1, WS>
           : RC == 2 ? (const void*)resample_kernel<2, WS>
           : RC == 4 ? (const void*)resample_kernel<4, WS>
           : RC == 8 ? (const void*)resample_kernel<8, WS>
                     : nullptr;
}

}  // namespace

// bank: W f32 [G, band_max, 8], meta: (base, band) int32 [G, 2], as
// ops/resample.py::band_bank builds them; the launch as k15_plan chooses it (ws: the
// block's bank rows staged in shared memory after the tile, smem counting them)
extern "C" int skt_resample(const float* x, const float* hist, const void* bank,
                            const int32_t* meta, float* out, int B, int n, int Lq, int Mq,
                            int pitch, int n_out, int G, int band_max, int GB, int slabs,
                            int RC, int smem, int ws, void* stream) {
    if (B <= 0 || n_out <= 0) return 0;
    if (Lq <= 0 || Mq <= 0 || (pitch != Mq && pitch != Mq + 1) || G <= 0 || GB <= 0 ||
        slabs <= 0 || smem <= 0 || smem > 227 * 1024 ||
        (ws && smem / 4 < GB * band_max * 8))
        return (int)cudaErrorInvalidValue;
    const float4* w = static_cast<const float4*>(bank);
    const int2* m = reinterpret_cast<const int2*>(meta);
    const cudaStream_t s = (cudaStream_t)stream;
    return ws ? dispatch<true>(RC, x, hist, w, m, out, B, n, Lq, Mq, pitch, n_out, G, band_max, GB, slabs, smem, s)
              : dispatch<false>(RC, x, hist, w, m, out, B, n, Lq, Mq, pitch, n_out, G, band_max, GB, slabs, smem, s);
}

// out[0] registers a thread, out[1] local (spilled) bytes a thread, out[2]
// resident blocks an SM at `threads` a block and `smem` shared bytes
extern "C" int skt_resample_occupancy(int RC, int ws, int threads, int smem, int* out) {
    const void* fn = ws ? kernel_of<true>(RC) : kernel_of<false>(RC);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    int per_sm = 0;
    cudaError_t e = cudaFuncGetAttributes(&a, fn);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = per_sm;
    return 0;
}
