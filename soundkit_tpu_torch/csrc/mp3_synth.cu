// MP3 granule decode (K10): one launch decodes one granule of every
// stream straight from its packed wire row: the wire's fields, the scale
// 2^(expq / 4), requantize, M/S stereo, the alias butterflies, the IMDCT,
// overlap-add, frequency inversion and the polyphase synthesis filterbank.
//
// Replaces soundkit_tpu/ops/mp3_batch.py::mp3_granule_device_compact_packed
// (:320) and the step it runs, _mp3_granule_device (:133-226), which the
// JAX package leaves to XLA outside any Pallas kernel: the wire views,
// the requantize, M/S and alias glue, a long [18 -> 36] and three short
// [6 -> 12] IMDCTs per subband (both computed, then one selected), the
// window bank, the overlap with the carried [32, 18] state, and 18
// rounds of a [32 -> 64] matrixing shifted into a 1024-deep FIFO, a
// 512-tap gather, the D window and a 16-term sum.
//
// What bounds it: bytes. A channel lane reads its int16 quant and
// quarter-exponents (2,304 B), its overlap (2,304) and FIFO (4,096) and
// writes its PCM, overlap and FIFO: 17.4 KB a lane against ~0.14 MFLOP,
// so at an H100 SXM's data-sheet peaks (3.35 TB/s, 67 TFLOP/s float32)
// the bytes take about three times as long as the FMAs. Nothing between
// the wire and the outputs goes to HBM: every intermediate lives in
// shared memory or registers, and each input byte is read once.
//
// - One block a stream, THREADS threads a channel, so that M/S reads the
//   partner's lines from shared memory; a stereo block takes 384 threads
//   and 21 KB of shared memory. The wire's lines come in 16-byte loads
//   where the row allows them (its quant and expq fields start on a
//   16-byte boundary for every B, a row at g * stride does when the
//   stride does), else in 4-byte ones.
// - The IMDCT tables and the alias coefficients are staged in shared
//   memory once a stream; the matrixing column and the D window go from
//   the table (L2) straight into registers: a thread's matrixing column
//   i = t % 64 and its windowed-sum column j = t % 32 never change.
// - A channel's shared memory is one line of EXT words, reused phase by
//   phase: the raw int16 lines, then the sub-band samples after the
//   overlap ([k][round], a matrixing thread's RB rounds of a row in three
//   8-byte loads), in its first 576 words; the requantized lines in the
//   next 576; the rounds' matrixing outputs over both; the old FIFO
//   behind them.
// - Each subband takes only the path it uses: short where the block
//   type is 2 and not (mixed and subband < 2), else long with window row
//   `block_type` (row 0 for type 2 and for the mixed lane's subbands 0-1).
// - The FIFO needs no shifting. The rounds' matrixing outputs v_17 .. v_0
//   are laid in front of the old FIFO in one extended line of
//   18 * 64 + 1024 words; round r's FIFO is the 1024 words from
//   64 * (17 - r), and the new FIFO, newest first, is the first 1024.
// - IEEE float32 on the CUDA cores (powf, exp2f, FMAs), never TF32: the
//   reference pins float32 for this path (`jax.default_matmul_precision`).
//
// What the reference defines and the kernel follows: M/S is taken before
// validity is looked at, so a valid channel 0 under M/S reads channel 1's
// wire lines even where channel 1 is invalid; with one channel there is
// no M/S, and the wire's channel 1 is never read. The alias butterflies
// of boundary sb (1..31) run where sb <= n_alias_sb. An invalid channel
// writes zero PCM and passes its state through. Block types outside 0..3
// pick their window row as the reference's gather does (negative rows
// count from the end, then clamp to 0..3).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 192;  // a channel's threads: 576 / 192 = 3 lines a thread
constexpr int NSB = 32;       // subbands
constexpr int NL = 18;        // lines a subband, rounds a granule
constexpr int GRANULE = NSB * NL;
constexpr int PER = GRANULE / THREADS;  // lines (and PCM samples) a thread
constexpr int FIFO = 1024;
constexpr int EXT = NL * 64 + FIFO;  // v_17 .. v_0, then the old FIFO
constexpr int RB = 6;                // rounds a thread's matrixing sums at once
constexpr int MPER = NL / RB * 64 / THREADS;  // (column, RB rounds) pairs a matrixing thread sums
constexpr int BUTTERFLIES = 31 * 8;
constexpr int FIELD = GRANULE * 2;  // bytes of one channel's quant (or expq) on the wire

// the packed table (float32 words), as ops/mp3_synth.py::kernel_tables lays it out
constexpr int T_M36 = 0;                // IMDCT 36, transposed: [18][36]
constexpr int T_WIN = T_M36 + 18 * 36;  // long windows by block type: [4][36]
constexpr int T_M12 = T_WIN + 4 * 36;   // IMDCT 12, transposed: [6][12]
constexpr int T_WS = T_M12 + 6 * 12;    // short window: [12]
constexpr int T_CS = T_WS + 12;         // alias butterflies: cs [8]
constexpr int T_CA = T_CS + 8;          // and ca [8]
constexpr int T_STAGED = T_CA + 8;      // the part staged in shared memory
constexpr int T_NT = T_STAGED;          // matrixing, transposed: [32][64]
constexpr int T_D = T_NT + 32 * 64;     // D window: [512]
constexpr int T_SIZE = T_D + 512;

static_assert(GRANULE % THREADS == 0 && (NL / RB * 64) % THREADS == 0 && THREADS % 32 == 0 &&
              NL % RB == 0 && RB % 2 == 0,
              "a thread's lines, and its matrixing outputs, divide evenly; a warp's columns "
              "share their rounds, and its windowed-sum column stays put");
static_assert(2 * FIELD == GRANULE * 4 && 2 * GRANULE <= NL * 64,
              "the raw lines, then the sub-band samples, and the requantized lines fit "
              "before the old FIFO");

struct WireOffsets {  // byte offsets of the fields in a packed wire row (mp3_wire_layout)
    int bt, nal, quant, expq, mixed, ms, valid;
};

__device__ __forceinline__ int window_row(int bt) {
    const int row = bt < 0 ? bt + 4 : bt;
    return row < 0 ? 0 : (row > 3 ? 3 : row);
}

__device__ __forceinline__ int32_t wire_i32(const uint8_t* p) {
    return *reinterpret_cast<const int32_t*>(p);
}

// A channel's quant and expq fields into `raw` (int16 [2][576]), in
// vectors of V: thread lt copies words lt, lt + THREADS, ...
template <typename V>
__device__ __forceinline__ void stage_lines(int16_t* raw, const uint8_t* quant, const uint8_t* expq,
                                            int lt) {
    constexpr int N = FIELD / sizeof(V);
    V* dst = reinterpret_cast<V*>(raw);
    for (int v = lt; v < 2 * N; v += THREADS)
        dst[v] = v < N ? reinterpret_cast<const V*>(quant)[v] : reinterpret_cast<const V*>(expq)[v - N];
}

// sign(q) |q|^(4/3) 2^(e / 4), in the reference's order; 0 for the sentinel -32768
__device__ __forceinline__ float requantize(int q, int e) {
    const float scale = e == -32768 ? 0.f : exp2f(0.25f * (float)e);
    const float sq = q > 0 ? 1.f : (q < 0 ? -1.f : 0.f);
    return (sq * powf(fabsf((float)q), 4.f / 3.f)) * scale;
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

template <int C>
__global__ void __launch_bounds__(THREADS * C)
mp3_granule_kernel(const uint8_t* __restrict__ wire, WireOffsets off,
                   const float* __restrict__ overlap, const float* __restrict__ fifo,
                   const float* __restrict__ tables, float* __restrict__ pcm,
                   float* __restrict__ new_overlap, float* __restrict__ new_fifo) {
    __shared__ float tab[T_STAGED];
    // a channel's line: raw lines / sub-band samples [0, 576), requantized
    // lines [576, 1152), then v_17 .. v_0 over both; the old FIFO from NL * 64
    __shared__ __align__(16) float ext[C][EXT];

    const int b = blockIdx.x;
    const int c = threadIdx.x / THREADS;
    const int lt = threadIdx.x % THREADS;
    const long lane = (long)b * C + c;
    const uint8_t* valid_b = wire + off.valid + 2 * b;
    const bool valid = valid_b[c] != 0;
    const bool ms = C == 2 && wire[off.ms + b] != 0;
    // this channel's lines feed its own synthesis or, under M/S, its partner's
    const bool lines = valid || (ms && valid_b[1 - c] != 0);
    float* e = ext[c];
    float* xc = e + GRANULE;
    float* sc = e;

    float ov[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) ov[k] = overlap[lane * GRANULE + lt + THREADS * k];
    {
        const float4* src = reinterpret_cast<const float4*>(fifo + lane * FIFO);
        float4* dst = reinterpret_cast<float4*>(e + NL * 64);
        for (int v = lt; v < FIFO / 4; v += THREADS) dst[v] = src[v];
    }
    if (lines) {
        const long at = (2L * b + c) * FIELD;
        const uint8_t* q = wire + off.quant + at;
        const uint8_t* xq = wire + off.expq + at;
        int16_t* raw = reinterpret_cast<int16_t*>(e);
        if ((reinterpret_cast<uintptr_t>(q) & 15) == 0 && (reinterpret_cast<uintptr_t>(xq) & 15) == 0)
            stage_lines<uint4>(raw, q, xq, lt);
        else
            stage_lines<uint32_t>(raw, q, xq, lt);
    }
    for (int n = threadIdx.x; n < T_STAGED; n += THREADS * C) tab[n] = tables[n];
    __syncthreads();

    if (lines) {
        const int16_t* raw = reinterpret_cast<const int16_t*>(e);
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int n = lt + THREADS * k;
            xc[n] = requantize(raw[n], raw[GRANULE + n]);
        }
    }
    __syncthreads();

    if (ms && lines) {  // block-uniform: under M/S both channels' `lines` agree
        const float inv = 0.7071067811865476f;  // float32(1 / sqrt(2))
        float y[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int n = lt + THREADS * k;
            const float m = ext[0][GRANULE + n], sd = ext[C - 1][GRANULE + n];
            y[k] = (c == 0 ? m + sd : m - sd) * inv;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < PER; ++k) xc[lt + THREADS * k] = y[k];
        __syncthreads();
    }

    int bt = 0;
    bool mx = false;
    if (valid) {
        bt = wire_i32(wire + off.bt + 4 * (2 * b + c));
        mx = wire[off.mixed + 2 * b + c] != 0;
        const int nal = wire_i32(wire + off.nal + 4 * (2 * b + c));
        // the butterflies of boundaries 1..min(nal, 31); they touch disjoint lines
        for (int j = lt; j < BUTTERFLIES; j += THREADS) {
            const int sb = j / 8 + 1, i = j % 8;
            if (sb <= nal) {
                const int ia = NL * sb - 1 - i, ib = NL * sb + i;
                const float xa = xc[ia], xb = xc[ib];
                const float cs = tab[T_CS + i], ca = tab[T_CA + i];
                xc[ia] = xa * cs - xb * ca;
                xc[ib] = xb * cs + xa * ca;
            }
        }
    }
    __syncthreads();

    // IMDCT, overlap-add and frequency inversion; the upper half is the next overlap
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int n = lt + THREADS * k;
        if (valid) {
            const int sb = n / NL, i = n % NL;
            float lo, hi;
            imdct_line(tab, xc, sb, i, bt, mx, lo, hi);
            float out = lo + ov[k];
            if (sb & i & 1) out = -out;
            sc[n] = out;  // [sb][round]
            new_overlap[lane * GRANULE + n] = hi;
        } else {  // frozen state, silent output
            new_overlap[lane * GRANULE + n] = ov[k];
            pcm[lane * GRANULE + n] = 0.f;
        }
    }
    __syncthreads();

    // matrixing: v_r[i] = sum_k N[i][k] s[k][r], into ext at 64 * (17 - r) + i;
    // pair p takes column i = p % 64 and the RB rounds from RB * (p / 64)
    float acc[MPER][RB];
    if (valid) {
#pragma unroll
        for (int m = 0; m < MPER; ++m) {
            const int p = lt + THREADS * m, i = p % 64, r0 = p / 64 * RB;
            const float* nt = tables + T_NT + i;
#pragma unroll
            for (int q = 0; q < RB; ++q) acc[m][q] = 0.f;
#pragma unroll 8
            for (int k = 0; k < NSB; ++k) {
                const float nk = __ldg(nt + 64 * k);
                const float* row = sc + NL * k + r0;
#pragma unroll
                for (int q = 0; q < RB; q += 2) {
                    const float2 z = *reinterpret_cast<const float2*>(row + q);
                    acc[m][q] = fmaf(nk, z.x, acc[m][q]);
                    acc[m][q + 1] = fmaf(nk, z.y, acc[m][q + 1]);
                }
            }
        }
    }
    __syncthreads();  // every sub-band sample read before v overwrites them
    if (valid) {
#pragma unroll
        for (int m = 0; m < MPER; ++m) {
            const int p = lt + THREADS * m, i = p % 64, r0 = p / 64 * RB;
#pragma unroll
            for (int q = 0; q < RB; ++q) e[64 * (NL - 1 - r0 - q) + i] = acc[m][q];
        }
    }
    __syncthreads();

    if (valid) {
        // windowed sums: pcm[32 r + j] = sum_g u_r[32 g + j] D[32 g + j], where
        // u_r[32 g + j] = fifo_r[128 (g / 2) + 96 (g % 2) + j]
        const int j = lt % 32;
        float d[16];
#pragma unroll
        for (int g = 0; g < 16; ++g) d[g] = __ldg(tables + T_D + 32 * g + j);
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int n = lt + THREADS * k;
            const float* f = e + 64 * (NL - 1 - n / 32) + j;
            float acc = 0.f;
#pragma unroll
            for (int g = 0; g < 16; ++g) acc = fmaf(f[128 * (g >> 1) + 96 * (g & 1)], d[g], acc);
            pcm[lane * GRANULE + n] = acc;
        }
    }
    // the new FIFO: the newest 1024 words, or the old FIFO passed through
    {
        const float4* src = reinterpret_cast<const float4*>(e + (valid ? 0 : NL * 64));
        float4* dst = reinterpret_cast<float4*>(new_fifo + lane * FIFO);
        for (int v = lt; v < FIFO / 4; v += THREADS) dst[v] = src[v];
    }
}

}  // namespace

extern "C" int skt_mp3_granule(const uint8_t* wire, int off_bt, int off_nal, int off_quant,
                               int off_expq, int off_mixed, int off_ms, int off_valid,
                               const float* overlap, const float* fifo, const float* tables,
                               float* pcm, float* new_overlap, float* new_fifo, int B, int C,
                               void* stream) {
    if (B <= 0) return 0;
    const WireOffsets off{off_bt, off_nal, off_quant, off_expq, off_mixed, off_ms, off_valid};
    const cudaStream_t s = (cudaStream_t)stream;
    if (C == 2)
        mp3_granule_kernel<2><<<(unsigned)B, THREADS * 2, 0, s>>>(wire, off, overlap, fifo, tables,
                                                                  pcm, new_overlap, new_fifo);
    else if (C == 1)
        mp3_granule_kernel<1><<<(unsigned)B, THREADS, 0, s>>>(wire, off, overlap, fifo, tables, pcm,
                                                              new_overlap, new_fifo);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
