// Windowed IMDCT product: out[L, N] = (A[L, K] @ Mt[K, N]) * bank[win_idx[row], :].
//
// Replaces soundkit_tpu/ops/pallas_kernels.py::imdct_window_pallas
// (_imdct_kernel) and, with DEQUANT = true, ::aac_dequant_imdct_window_pallas
// (_dequant_imdct_kernel), whose A operand is sign(q) * |q|^(4/3) * scale.
// On the AAC-LC main path it is the synthesis product that
// soundkit_tpu/ops/aac_batch.py:_aac_decode_frame_device runs in XLA: long
// blocks L = B*C, K = 1024, N = 2048 and short blocks L = 8*B*C, K = 128,
// N = 256, with the window taken from a bank row per output row (the
// bank[seq, prev, shape] gather).
//
// What bounds it: fp32 FMA issue. The reference pins the product to
// float32 (the >90 dB oracle bars), so the tensor cores (TF32 keeps 10
// mantissa bits) are out and the ceiling is the card's plain FFMA rate.
// Design: a shared-memory tiled SGEMM. Each 256-thread block owns a 64x64
// output tile and walks K in 16-deep slices staged in shared memory; each
// thread keeps a 4x4 micro-tile in registers, so every shared-memory value
// it reads feeds four FMAs and global traffic per FMA falls by 16x against
// a dot product per output. The window multiply is the epilogue, so the
// unwindowed product never reaches device memory. K must be a multiple of
// 16 and N of 64 (the wrapper checks); rows are masked.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int APAD = 4;  // breaks the 64-float stride of the transposed A tile

template <bool DEQUANT>
__global__ void __launch_bounds__(THREADS) imdct_window_kernel(
    const void* __restrict__ a, const float* __restrict__ scale,
    const float* __restrict__ mt, const float* __restrict__ bank,
    const int32_t* __restrict__ win_idx, float* __restrict__ out, int L, int K,
    int N) {
    __shared__ float As[BK][BM + APAD];
    __shared__ float Bs[BK][BN];
    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
        for (int i = 0; i < (BM * BK) / THREADS; ++i) {
            const int e = tid + i * THREADS;
            const int r = e / BK;
            const int c = e % BK;
            const int row = row0 + r;
            float v = 0.f;
            if (row < L) {
                const long idx = (long)row * K + k0 + c;
                if (DEQUANT) {
                    const float q = (float)static_cast<const int32_t*>(a)[idx];
                    v = copysignf(powf(fabsf(q), 4.0f / 3.0f), q) * scale[idx];
                } else {
                    v = static_cast<const float*>(a)[idx];
                }
            }
            As[c][r] = v;
        }
#pragma unroll
        for (int i = 0; i < (BK * BN) / THREADS; ++i) {
            const int e = tid + i * THREADS;
            const int r = e / BN;
            const int c = e % BN;
            Bs[r][c] = mt[(long)(k0 + r) * N + col0 + c];
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float av[TM];
            float bv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
            for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int row = row0 + ty * TM + i;
        if (row >= L) continue;
        const float* w = bank + (long)win_idx[row] * N;
        float* o = out + (long)row * N;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int col = col0 + tx * TN + j;
            o[col] = acc[i][j] * w[col];
        }
    }
}

template <bool DEQUANT>
int launch(const void* a, const float* scale, const float* mt, const float* bank,
           const int32_t* win_idx, float* out, int L, int K, int N, void* stream) {
    dim3 grid(N / BN, (L + BM - 1) / BM);
    imdct_window_kernel<DEQUANT><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        a, scale, mt, bank, win_idx, out, L, K, N);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int skt_imdct_window(const float* coef, const float* mt, const float* bank,
                     const int32_t* win_idx, float* out, int L, int K, int N,
                     void* stream) {
    return launch<false>(coef, nullptr, mt, bank, win_idx, out, L, K, N, stream);
}

int skt_dequant_imdct_window(const int32_t* quant, const float* scale,
                             const float* mt, const float* bank,
                             const int32_t* win_idx, float* out, int L, int K,
                             int N, void* stream) {
    return launch<true>(quant, scale, mt, bank, win_idx, out, L, K, N, stream);
}

}  // extern "C"
