// Windowed IMDCT product on the tensor cores:
// out[L, N] = (A[L, K] @ M[N, K]^T) * bank[win_idx[row], :].
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
// What bounds it: the multiply-adds. The reference pins the product to
// float32 (plain TF32, 10 mantissa bits, lands near 1e-3 of the output
// against the 1e-5 the port holds), so on plain FFMA the long product's
// 8.59 GFLOP take at least 0.128 ms at 67 TFLOP/s. Design: 3xTF32 on the
// tensor cores. Each operand is split into hi, x with its 13 low mantissa
// bits cleared (a TF32 value), and lo = x - hi (exact in float32, of
// which wgmma reads the TF32 part, as it reads every tf32 operand); the
// product is lo·hi + hi·lo + hi·hi summed in float32 (lo·lo, below
// float32's last bit, is dropped): three TF32 products at 495 TFLOP/s,
// 0.052 ms for the long product. Clearing bits costs one integer op where
// cvt.rna.tf32.f32 costs a conversion, and the rounding of hi moves into
// lo, so the error stays that of rounding lo. The tensor
// cores' float32 sums lose more than IEEE adds over a long K (in one
// accumulator over K = 1024 the error comes close to the 1e-5 bound), so
// each 32-deep stage sums into a fresh accumulator that is then added
// into the running one with IEEE adds.
//
// A 256-thread block (two warpgroups) owns a 128 x 128 output tile; each
// warpgroup keeps its 64 x 128 running sum and stage sum in registers.
// K is walked in 32-deep stages: cp.async brings each stage's raw tiles
// (the basis M, K-major as wgmma's tf32 operands must be, and A) three
// stages ahead into a 3-slot ring (two for DEQUANT, whose A is twice the
// bytes); the block then splits a raw stage into hi and lo tiles of both
// operands in wgmma's no-swizzle core-matrix order (8 rows x 16 bytes per
// core matrix), DEQUANT computing A on the way, and wgmma.m64n128k8 reads
// both from shared memory. Stage k's products run on the tensor cores
// while stage k + 3 loads and stage k + 1 is split into the other split
// buffer. The operand traffic from L2 bounds this kernel more than the
// tensor cores do (with one product in place of three it is barely
// faster on an H100), so the constant basis is split here rather than
// once on the host, which would double its bytes, and the ring keeps as
// many stages in flight as shared memory holds. The window
// multiply is the epilogue, so the unwindowed product never reaches
// device memory. K must be a multiple of 32 and N of 128 (the wrapper
// checks); rows are masked.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int TILE = BM * BK;           // floats of one operand tile (BM == BN)
constexpr uint32_t LBO = BM * 16;       // bytes between the K-adjacent core matrices
constexpr uint32_t SBO = 8 * 16;        // bytes between the M/N-adjacent core matrices

// Shared memory, in floats: SLOTS raw stages (the basis tile in
// core-matrix order, then A row-major with its 16-byte chunks swizzled,
// DEQUANT: quant then scale), then two split buffers of four core-matrix
// tiles each (A hi, A lo, B hi, B lo): 224 KB either way.
template <bool DEQUANT>
struct Smem {
    static constexpr int SLOTS = DEQUANT ? 2 : 3;  // raw stages in the ring
    static constexpr int A_RAW = BM * BK;
    static constexpr int RAW = TILE + (DEQUANT ? 2 : 1) * A_RAW;
    static constexpr int SPLIT = 4 * TILE;
    static constexpr int FLOATS = SLOTS * RAW + 2 * SPLIT;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wgmma matrix descriptor of a no-swizzle K-major tile: start address,
// leading byte offset (K direction) and stride byte offset (M/N
// direction), each in 16-byte units; layout type 0 (no swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
         | ((uint64_t)(LBO >> 4) << 16)
         | ((uint64_t)(SBO >> 4) << 32);
}

// d[64 x 128] = A[64 x 8] * B[8 x 128] + (scale_d ? d : 0), one warpgroup;
// both operands tf32 in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries (fence, wait).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Position (floats) of 16-byte chunk c of row r in a core-matrix tile:
// core matrices of 8 rows x 16 bytes, 16 along M/N, then 8 along K.
__device__ __forceinline__ int cm_off(int r, int c) {
    return c * (BM * 4) + (r / 8) * 32 + (r % 8) * 4;
}

template <bool DEQUANT>
__device__ __forceinline__ void load_raw(float* raw, const void* a, const float* scale,
                                         const float* m, int row0, int col0, int k0, int L,
                                         int K, int tid) {
    using S = Smem<DEQUANT>;
    constexpr int CH = BK / 4;  // 16-byte chunks per row of a stage
#pragma unroll
    for (int i = 0; i < BN * CH / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int n = e / CH;
        const int c = e % CH;
        cp_async16(raw + cm_off(n, c), m + (long)(col0 + n) * K + k0 + 4 * c, 16);
    }
    // rows past L read zeros
    constexpr int NA = DEQUANT ? 2 : 1;
#pragma unroll
    for (int i = 0; i < NA * BM * CH / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int arr = e / (BM * CH);
        const int r = (e % (BM * CH)) / CH;
        const int c = e % CH;
        const int row = row0 + r;
        const long idx = (long)min(row, L - 1) * K + k0 + 4 * c;
        const void* src = arr ? (const void*)(scale + idx)
                              : (const void*)(static_cast<const uint32_t*>(a) + idx);
        // chunk c of row r at slot c ^ (r % 8): the split's reads, eight rows
        // at a time, then hit distinct banks
        cp_async16(raw + TILE + arr * S::A_RAW + r * BK + 4 * (c ^ (r % 8)), src, row < L ? 16 : 0);
    }
}

// hi keeps x's top 19 bits (sign, exponent, 10 mantissa bits); lo = x - hi
// is exact in float32, and wgmma reads its top 19 bits.
__device__ __forceinline__ void split4(float4 x, float4* hi, float4* lo) {
    const float4 h = make_float4(__uint_as_float(__float_as_uint(x.x) & 0xffffe000u),
                                 __uint_as_float(__float_as_uint(x.y) & 0xffffe000u),
                                 __uint_as_float(__float_as_uint(x.z) & 0xffffe000u),
                                 __uint_as_float(__float_as_uint(x.w) & 0xffffe000u));
    *hi = h;
    *lo = make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
}

__device__ __forceinline__ float dequant1(float q_bits, float scale) {
    const float q = (float)__float_as_int(q_bits);
    return copysignf(powf(fabsf(q), 4.0f / 3.0f), q) * scale;
}

// Raw stage -> split buffer: A (dequantized for DEQUANT) and the basis
// into hi and lo halves, both in core-matrix order.
template <bool DEQUANT>
__device__ __forceinline__ void split_stage(const float* raw, float* sp, int tid) {
    using S = Smem<DEQUANT>;
    constexpr int CH = BK / 4;
#pragma unroll
    for (int i = 0; i < TILE / 4 / THREADS; ++i) {
        const int f = tid + i * THREADS;
        // basis: same position in the raw and split tiles
        split4(reinterpret_cast<const float4*>(raw)[f], reinterpret_cast<float4*>(sp + 2 * TILE) + f,
               reinterpret_cast<float4*>(sp + 3 * TILE) + f);
        // A: row r fastest across the threads
        const int r = f % BM;
        const int c = f / BM;
        const float* ar = raw + TILE + r * BK + 4 * (c ^ (r % 8));
        float4 x = *reinterpret_cast<const float4*>(ar);
        if (DEQUANT) {
            const float4 sc = *reinterpret_cast<const float4*>(ar + S::A_RAW);
            x = make_float4(dequant1(x.x, sc.x), dequant1(x.y, sc.y), dequant1(x.z, sc.z),
                            dequant1(x.w, sc.w));
        }
        const int o = cm_off(r, c) / 4;
        split4(x, reinterpret_cast<float4*>(sp) + o, reinterpret_cast<float4*>(sp + TILE) + o);
    }
    static_assert(TILE / 4 % THREADS == 0 && CH * BM == TILE / 4, "tile split");
}

template <bool DEQUANT>
__global__ void __launch_bounds__(THREADS, 1) imdct_window_kernel(
    const void* __restrict__ a, const float* __restrict__ scale, const float* __restrict__ m,
    const float* __restrict__ bank, const int32_t* __restrict__ win_idx,
    float* __restrict__ out, int L, int K, int N) {
    using S = Smem<DEQUANT>;
    extern __shared__ __align__(128) float smem[];
    constexpr int NR = S::SLOTS;
    float* const raw0 = smem;                  // raw stage j at raw0 + (j % NR) * S::RAW
    float* const split0 = smem + NR * S::RAW;  // split stage j at split0 + (j & 1) * S::SPLIT
    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;
    const int KT = K / BK;

    float d[64];  // running sum
    float e[64];  // one stage's sum
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        d[i] = 0.f;
        e[i] = 0.f;
    }

#pragma unroll
    for (int j = 0; j < NR; ++j) {
        if (j < KT) load_raw<DEQUANT>(raw0 + j * S::RAW, a, scale, m, row0, col0, j * BK, L, K, tid);
        cp_async_commit();
    }
    cp_async_wait<NR - 1>();
    __syncthreads();
    split_stage<DEQUANT>(raw0, split0, tid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    for (int kt = 0; kt < KT; ++kt) {
        // stage kt on the tensor cores ...
        const float* sp = split0 + (kt & 1) * S::SPLIT;
        fence_acc(e);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int s = 0; s < BK / 8; ++s) {
            const int ko = 2 * s * (BM * 4);                  // k-step s: chunks 2s, 2s + 1
            const uint64_t ahi = smem_desc(sp + ko + wg * 256);  // this warpgroup's 64 rows
            const uint64_t alo = smem_desc(sp + TILE + ko + wg * 256);
            const uint64_t bhi = smem_desc(sp + 2 * TILE + ko);
            const uint64_t blo = smem_desc(sp + 3 * TILE + ko);
            wgmma_tf32(e, alo, bhi, s > 0);
            wgmma_tf32(e, ahi, blo, 1);
            wgmma_tf32(e, ahi, bhi, 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");

        // ... while stage kt + NR loads and stage kt + 1 is split
        if (kt + NR < KT)
            load_raw<DEQUANT>(raw0 + (kt % NR) * S::RAW, a, scale, m, row0, col0, (kt + NR) * BK,
                              L, K, tid);
        cp_async_commit();
        if (kt + 1 < KT) {
            cp_async_wait<NR - 1>();
            __syncthreads();
            split_stage<DEQUANT>(raw0 + ((kt + 1) % NR) * S::RAW, split0 + ((kt + 1) & 1) * S::SPLIT,
                                 tid);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(e);
#pragma unroll
        for (int i = 0; i < 64; ++i) d[i] += e[i];
        __syncthreads();
    }

    // accumulator d[4j + h]: row 16 * warp + lane / 4 + 8 * (h / 2) of the
    // warpgroup's 64, column 8j + 2 * (lane % 4) + h % 2
    const int lane = tid % 32;
    const int t = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = row0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4 + 8 * h;
        if (row >= L) continue;
        const float* w = bank + (long)win_idx[row] * N + col0;
        float* o = out + (long)row * N + col0;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int col = 8 * j + 2 * t;
            const float2 wv = *reinterpret_cast<const float2*>(w + col);
            *reinterpret_cast<float2*>(o + col) =
                make_float2(d[4 * j + 2 * h] * wv.x, d[4 * j + 2 * h + 1] * wv.y);
        }
    }
}

template <bool DEQUANT>
int launch(const void* a, const float* scale, const float* m, const float* bank,
           const int32_t* win_idx, float* out, int L, int K, int N, void* stream) {
    const int smem = Smem<DEQUANT>::FLOATS * (int)sizeof(float);
    static bool configured = false;  // once per process: the call costs host time
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(imdct_window_kernel<DEQUANT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    dim3 grid(N / BN, (L + BM - 1) / BM);
    imdct_window_kernel<DEQUANT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        a, scale, m, bank, win_idx, out, L, K, N);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int skt_imdct_window(const float* coef, const float* m, const float* bank,
                     const int32_t* win_idx, float* out, int L, int K, int N, void* stream) {
    return launch<false>(coef, nullptr, m, bank, win_idx, out, L, K, N, stream);
}

int skt_dequant_imdct_window(const int32_t* quant, const float* scale, const float* m,
                             const float* bank, const int32_t* win_idx, float* out, int L,
                             int K, int N, void* stream) {
    return launch<true>(quant, scale, m, bank, win_idx, out, L, K, N, stream);
}

}  // extern "C"
