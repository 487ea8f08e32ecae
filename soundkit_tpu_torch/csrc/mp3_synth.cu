// MP3 granule synthesis (K10): IMDCT, overlap-add, frequency inversion
// and the polyphase synthesis filterbank of one granule a channel lane.
//
// Replaces the body of soundkit_tpu/ops/mp3_batch.py::_mp3_granule_device
// from the subband reshape to its return (:167-226), which the JAX
// package leaves to XLA outside any Pallas kernel: a long [18 -> 36] and
// three short [6 -> 12] IMDCTs per subband (both computed, then one
// selected), the window bank, the overlap with the carried [32, 18]
// state, and 18 rounds of a [32 -> 64] matrixing shifted into a
// 1024-deep FIFO, a 512-tap gather, the D window and a 16-term sum. As
// plain torch that is about a hundred launches a granule.
//
// What bounds it: bytes. A lane reads its 576 lines, its overlap (576)
// and FIFO (1024) and writes its PCM, overlap and FIFO: 17.4 KB a lane
// against ~0.13 MFLOP, so at an H100 SXM's data-sheet peaks (3.35 TB/s,
// 67 TFLOP/s float32) the bytes take three times as long as the FMAs.
// The design keeps every intermediate in shared memory and moves each of
// those bytes once, coalesced.
//
// - One block a channel lane. An invalid lane (no granule this round)
//   copies its state through and writes zero PCM, with no arithmetic.
// - The tables (IMDCT matrices, window bank, short window, the
//   matrixing transposed, the D window; one packed float32 array made
//   by ops/mp3_synth.py) are staged in shared memory, where the threads
//   of a warp read consecutive words.
// - Each subband takes only the path it uses: short where the block
//   type is 2 and not (mixed and subband < 2), else long with window row
//   `block_type` (row 0 for type 2 and for the mixed lane's subbands 0-1).
// - The FIFO needs no shifting. The rounds' matrixing outputs v_17 .. v_0
//   are laid in front of the old FIFO in one extended line of
//   18 * 64 + 1024 words; round r's FIFO is the 1024 words from
//   64 * (17 - r), and the new FIFO, newest first, is the first 1024.
//   So the 18 rounds are independent: every v is computed at once, then
//   every PCM sample as a 16-term windowed sum over that line.
// - IEEE float32 FMAs on the CUDA cores, never TF32: the reference pins
//   float32 for this path (`jax.default_matmul_precision("float32")`).
//
// Block types outside 0..3 pick their window row as the reference's
// gather does (negative rows count from the end, then clamp to 0..3).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 192;  // 6 warps: 576 / 192 = 3 lines a thread
constexpr int NSB = 32;       // subbands
constexpr int NL = 18;        // lines a subband, rounds a granule
constexpr int GRANULE = NSB * NL;
constexpr int FIFO = 1024;
constexpr int EXT = NL * 64 + FIFO;  // v_17 .. v_0, then the old FIFO
constexpr int RB = 6;                // rounds a thread's matrixing sums at once

// the packed table (float32 words), as ops/mp3_synth.py::kernel_tables lays it out
constexpr int T_M36 = 0;                // IMDCT 36, transposed: [18][36]
constexpr int T_WIN = T_M36 + 18 * 36;  // long windows by block type: [4][36]
constexpr int T_M12 = T_WIN + 4 * 36;   // IMDCT 12, transposed: [6][12]
constexpr int T_WS = T_M12 + 6 * 12;    // short window: [12]
constexpr int T_NT = T_WS + 12;         // matrixing, transposed: [32][64]
constexpr int T_D = T_NT + 32 * 64;     // D window: [512]
constexpr int T_SIZE = T_D + 512;

static_assert(GRANULE % THREADS == 0 && (NL * 64) % (THREADS * RB) == 0 && THREADS % 64 == 0,
              "a thread's lines, and its matrixing outputs, divide evenly");

__device__ __forceinline__ int window_row(int bt) {
    const int row = bt < 0 ? bt + 4 : bt;
    return row < 0 ? 0 : (row > 3 ? 3 : row);
}

// Line (sb, i) of the IMDCT: z[i] (into the overlap-add) and z[18 + i]
// (the next overlap).
__device__ __forceinline__ void imdct_line(const float* tab, const float* x, int sb, int i, int bt,
                                           bool mixed, float& lo, float& hi) {
    const float* X = x + NL * sb;
    const bool low_mixed = mixed && sb < 2;
    if (bt == 2 && !low_mixed) {
        // three 6 -> 12 IMDCTs of the interleaved windows X[3f + w], windowed and
        // summed at offsets 6, 12 and 18, in window order
        lo = 0.f;
        hi = 0.f;
#pragma unroll
        for (int w = 0; w < 3; ++w) {
            const int m_lo = i - 6 - 6 * w;       // z[i]
            const int m_hi = i + 18 - 6 - 6 * w;  // z[18 + i]
            if (m_lo >= 0 && m_lo < 12) {
                float acc = 0.f;
#pragma unroll
                for (int f = 0; f < 6; ++f) acc = fmaf(tab[T_M12 + 12 * f + m_lo], X[3 * f + w], acc);
                lo += acc * tab[T_WS + m_lo];
            }
            if (m_hi >= 0 && m_hi < 12) {
                float acc = 0.f;
#pragma unroll
                for (int f = 0; f < 6; ++f) acc = fmaf(tab[T_M12 + 12 * f + m_hi], X[3 * f + w], acc);
                hi += acc * tab[T_WS + m_hi];
            }
        }
        return;
    }
    const int row = (low_mixed || bt == 2) ? 0 : window_row(bt);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
        const float xk = X[k];
        a = fmaf(tab[T_M36 + 36 * k + i], xk, a);
        b = fmaf(tab[T_M36 + 36 * k + 18 + i], xk, b);
    }
    lo = a * tab[T_WIN + 36 * row + i];
    hi = b * tab[T_WIN + 36 * row + 18 + i];
}

__global__ void __launch_bounds__(THREADS)
mp3_synth_kernel(const float* __restrict__ xr, const int32_t* __restrict__ block_type,
                 const uint8_t* __restrict__ mixed, const uint8_t* __restrict__ valid,
                 const float* __restrict__ overlap, const float* __restrict__ fifo,
                 const float* __restrict__ tables, float* __restrict__ pcm,
                 float* __restrict__ new_overlap, float* __restrict__ new_fifo) {
    const long lane = blockIdx.x;
    const int t = threadIdx.x;
    const long lg = lane * GRANULE;
    const long lf = lane * FIFO;
    if (!valid[lane]) {  // frozen state, silent output
        for (int n = t; n < GRANULE; n += THREADS) {
            pcm[lg + n] = 0.f;
            new_overlap[lg + n] = overlap[lg + n];
        }
        for (int n = t; n < FIFO; n += THREADS) new_fifo[lf + n] = fifo[lf + n];
        return;
    }

    __shared__ float tab[T_SIZE];
    __shared__ float x[GRANULE];
    __shared__ float s[NSB][NL + 1];  // subband samples after the overlap, [k][round]
    __shared__ float ext[EXT];

    for (int n = t; n < T_SIZE; n += THREADS) tab[n] = tables[n];
    for (int n = t; n < GRANULE; n += THREADS) x[n] = xr[lg + n];
    for (int n = t; n < FIFO; n += THREADS) ext[NL * 64 + n] = fifo[lf + n];
    const int bt = block_type[lane];
    const bool mx = mixed[lane] != 0;
    __syncthreads();

    // IMDCT, overlap-add and frequency inversion; the upper half is the next overlap
    for (int n = t; n < GRANULE; n += THREADS) {
        const int sb = n / NL, i = n % NL;
        float lo, hi;
        imdct_line(tab, x, sb, i, bt, mx, lo, hi);
        float out = lo + overlap[lg + n];
        if (sb & i & 1) out = -out;
        s[sb][i] = out;
        new_overlap[lg + n] = hi;
    }
    __syncthreads();

    // matrixing: v_r[i] = sum_k N[i][k] s[k][r], into ext at 64 * (17 - r) + i.
    // A thread takes one i and RB rounds: one table read serves RB FMAs.
    for (int base = t * RB; base < NL * 64; base += THREADS * RB) {
        const int i = (base / RB) % 64;
        const int r0 = (base / RB) / 64 * RB;
        float acc[RB];
#pragma unroll
        for (int q = 0; q < RB; ++q) acc[q] = 0.f;
#pragma unroll 8
        for (int k = 0; k < NSB; ++k) {
            const float nk = tab[T_NT + 64 * k + i];
#pragma unroll
            for (int q = 0; q < RB; ++q) acc[q] = fmaf(nk, s[k][r0 + q], acc[q]);
        }
#pragma unroll
        for (int q = 0; q < RB; ++q) ext[64 * (NL - 1 - r0 - q) + i] = acc[q];
    }
    __syncthreads();

    // windowed sums: pcm[32 r + j] = sum_g u_r[32 g + j] D[32 g + j], where
    // u_r[32 g + j] = fifo_r[128 (g / 2) + 96 (g % 2) + j]
    for (int n = t; n < GRANULE; n += THREADS) {
        const int r = n / 32, j = n % 32;
        const float* f = ext + 64 * (NL - 1 - r) + j;
        float acc = 0.f;
#pragma unroll
        for (int g = 0; g < 16; ++g) acc = fmaf(f[128 * (g >> 1) + 96 * (g & 1)], tab[T_D + 32 * g + j], acc);
        pcm[lg + n] = acc;
    }
    for (int n = t; n < FIFO; n += THREADS) new_fifo[lf + n] = ext[n];
}

}  // namespace

extern "C" int skt_mp3_synth(const float* xr, const int32_t* block_type, const uint8_t* mixed,
                             const uint8_t* valid, const float* overlap, const float* fifo,
                             const float* tables, float* pcm, float* new_overlap, float* new_fifo,
                             int L, void* stream) {
    if (L <= 0) return 0;
    mp3_synth_kernel<<<(unsigned)L, THREADS, 0, (cudaStream_t)stream>>>(
        xr, block_type, mixed, valid, overlap, fifo, tables, pcm, new_overlap, new_fifo);
    return (int)cudaGetLastError();
}
