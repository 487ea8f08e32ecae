// AAC spectral Huffman decode from raw access-unit bytes (K4).
//
// Replaces soundkit_tpu/ops/aac_entropy.py::aac_spectral_decode_device, a
// lax.while_loop/scan that decodes one codeword on every lane per step.
// Each channel lane walks its section program (runs of codebook,
// codeword count, output base): per codeword one lookup by the next 16
// bits, the sign bits of unsigned codebooks, the codebook-11 escapes, and
// up to four stores into quant[lane, 0:1024].
//
// What bounds it: the chain of the longest lane. A codeword's bit
// position depends on the previous codeword's length, so a lane is one
// dependent walk of up to ~400 codewords (384 on the fixture batch), and
// the batch ends with its longest lane; the bytes (4 KB of output a lane)
// are far below it. The first design (one thread per lane, blocks of 128)
// put two or three dependent global loads on every codeword (the AU bytes
// of the window, then the flat [11, 65536] table in L2), and a warp of 32
// lanes paid for the union of its lanes' branches: ~2,000 cycles a
// codeword. This one takes every global load off the walk and lets no
// lane wait for another:
//
// - the table is two-level (ops/aac_entropy.py::two_level_table): 11 x 256
//   first-level entries by the window's top 8 bits, final or pointing to a
//   subtable by the next k bits; 3,958 int32 (15.8 KB), built from the flat
//   table so every 16-bit prefix gives the same entry, 0 included;
// - a block stages the table, its lanes' run programs and its AU rows (the
//   two channel lanes of an AU share a row) into shared memory with
//   cp.async, 16-byte pieces where the addresses allow, and keeps its
//   output rows there too (zeroed first, written back with coalesced
//   16-byte stores at the end; the wrapper allocates the output
//   uninitialised);
// - a lane reads its bits through a 64-bit reservoir in registers, refilled
//   once a codeword by selects from a word loaded one refill ahead;
// - one flat loop over a lane's codewords with no branch on the common
//   path (see decode_lane): a branch makes a warp run the union of its
//   lanes' paths, and a branch on the run's end let the compiler nest a
//   loop per run, so a lane waited for the warp's longest run;
// - each warp decodes only LANES_PER_WARP (4) lanes, fewer lanes for the
//   union of paths, and a block of LANES_PER_BLOCK (16) lanes spreads 2048
//   lanes over 128 SMs, one warp per scheduler; the other threads stage.
//   On an H100, 8 x 4 tied, and 16 x 16, 32 x 4 and 32 x 32 were slower.
//
// What is left (on one H100, chip_smoke.py's K4 row): ~500 cycles a
// codeword on the longest lane, about 150 issued instructions with the
// shared-memory loads' latency between them; fewer instructions a
// codeword is the next step.
//
// Every detail of the reference is kept for bit-exactness: the bit stream
// is the row's words read cyclically (the reference's % W wrap of its
// window reads), min(clz(~w), 24) for the escape prefix, sign bits only
// for unsigned codebooks, the codebook clamped to 1..11 for the table,
// dimension and sign, escapes only for codebook 11 itself (12-15 read
// codebook 11's table without escaping, as the reference's clamped
// gathers do), and stores at positions >= 1024 dropped.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int N_LINES = 1024;
constexpr int OUT_STRIDE = N_LINES + 4;  // a lane's output row in shared memory, in int32
constexpr int L1_BITS = 8;
constexpr int LANES_PER_BLOCK = 16;  // 8 AUs, both channel lanes of each
constexpr int LANES_PER_WARP = 4;    // lanes a warp decodes, on its first threads
constexpr int THREADS = LANES_PER_BLOCK / LANES_PER_WARP * 32;

__device__ __forceinline__ uint32_t be32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src));
}

// Copy n bytes (a multiple of 4) to shared memory with the block's
// threads; dst and src agree modulo 16, so the middle goes in 16-byte
// pieces and only the head and tail in 4-byte ones.
__device__ __forceinline__ void stage(char* dst, const char* src, int n) {
    const int head = min((int)((16 - ((uintptr_t)src & 15)) & 15), n);
    const int body = (n - head) & ~15;
    for (int i = threadIdx.x * 4; i < head; i += blockDim.x * 4) cp_async4(dst + i, src + i);
    for (int i = head + threadIdx.x * 16; i < head + body; i += blockDim.x * 16)
        cp_async16(dst + i, src + i);
    for (int i = head + body + threadIdx.x * 4; i < n; i += blockDim.x * 4)
        cp_async4(dst + i, src + i);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Shared memory of a block: each region has 16 bytes of slack so that it
// can mirror its source's alignment modulo 16.
__host__ __device__ __forceinline__ size_t smem_bytes(int table_len, int run_cols, int au_stride) {
    return align16((size_t)table_len * 4 + 16) +
           align16((size_t)LANES_PER_BLOCK * run_cols * 4 + 16) +
           align16((size_t)(LANES_PER_BLOCK / 2) * au_stride + 16) +
           (size_t)LANES_PER_BLOCK * OUT_STRIDE * 4;
}

// A shared-memory destination for src: 16-byte aligned base plus src's
// offset modulo 16.
__device__ __forceinline__ char* mirror(char* base16, const void* src) {
    return base16 + ((uintptr_t)src & 15);
}

// MSB-first bits of one AU row, read cyclically by 32-bit words.
struct BitReader {
    const uint32_t* words;  // the row in shared memory, bytes as stored
    int W;
    int next;        // index of the word after `ahead`
    uint32_t ahead;  // the next word
    uint64_t buf;    // valid bits at the top
    int nbits;

    __device__ __forceinline__ int step(int i) const { return i + 1 == W ? 0 : i + 1; }
    __device__ __forceinline__ void init(const uint32_t* w, int n_words, int bitpos) {
        words = w;
        W = n_words;
        const int w0 = (bitpos >> 5) % W;
        const int w1 = step(w0);
        const int w2 = step(w1);
        ahead = be32(words[w2]);
        next = step(w2);
        const int sh = bitpos & 31;
        buf = (((uint64_t)be32(words[w0]) << 32) | be32(words[w1])) << sh;
        nbits = 64 - sh;
    }
    // at least 32 valid bits after it; without a branch (the lanes of a
    // warp refill at different codewords)
    __device__ __forceinline__ void fill() {
        const bool need = nbits < 32;
        const uint64_t add = (uint64_t)ahead << (32 - min(nbits, 32));
        buf |= need ? add : 0;
        nbits += need ? 32 : 0;
        const uint32_t w = be32(words[next]);
        ahead = need ? w : ahead;
        next = need ? step(next) : next;
    }
    __device__ __forceinline__ uint32_t peek() const { return (uint32_t)(buf >> 32); }
    // n <= nbits
    __device__ __forceinline__ void skip(int n) {
        buf <<= n;
        nbits -= n;
    }
};

// One channel lane's codewords: lut is the two-level table, rr the
// lane's run program (nr >= 1 runs), words its AU row; q its zeroed
// output row. One flat loop over the lane's codewords, without a branch
// on the common path (a branch lets the lanes of a warp wait for each
// other): both table levels are read (the second at entry 0 when the
// first is final), the sign bits are placed with popc, a codeword and
// its signs (at most 20 bits) leave the reservoir in one shift, and the
// next run is taken by selects. Only codebook 11's escapes branch.
__device__ __forceinline__ void decode_lane(const int32_t* lut, const int32_t* rr, int run_cols,
                                            int nr, const uint32_t* words, int W, int bp0,
                                            int32_t* __restrict__ q) {
    BitReader br;
    br.init(words, W, bp0);

    int run_i = 0;
    int cw_i = 0;
    uint32_t r = (uint32_t)rr[0];
    uint32_t r_next = (uint32_t)rr[min(1, run_cols - 1)];
    for (;;) {
        const int raw = (int)(r & 15u);
        const int cb = min(max(raw, 1), 11);
        const int ncw = (int)((r >> 4) & 63u);
        const int base = (int)((r >> 10) & 4095u);
        const int dim = cb < 5 ? 4 : 2;
        const bool is_signed = cb <= 2 || cb == 5 || cb == 6;

        // codeword: the first level by the top 8 bits, a subtable by the next k
        br.fill();
        const uint32_t top = br.peek();
        const int first = lut[((cb - 1) << L1_BITS) + (top >> (32 - L1_BITS))];
        const int sub = lut[first < 0 ? (first & 0xFFFF) +
                                             ((top << L1_BITS) >> (32 - ((first >> 16) & 15)))
                                       : 0];
        const int entry = first < 0 ? sub : first;
        const int len = entry & 31;
        int vals[4];
        unsigned need_sign = 0;  // values that take a sign bit, one bit each
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            vals[i] = i < dim ? ((entry >> (5 + 6 * i)) & 63) - 16 : 0;
            need_sign |= (unsigned)(vals[i] != 0) << i;
        }
        need_sign = is_signed ? 0u : need_sign;

        // sign bits (unsigned codebooks), one per nonzero value, in order
        const uint32_t swin = (uint32_t)((br.buf << len) >> 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int before = __popc(need_sign & ((1u << i) - 1u));
            const bool neg = ((need_sign >> i) & (swin >> (31 - before)) & 1u) != 0;
            vals[i] = neg ? -vals[i] : vals[i];
        }
        br.skip(len + __popc(need_sign));

        // codebook-11 escapes, value 0 then value 1
        if (raw == 11 && (abs(vals[0]) == 16 || abs(vals[1]) == 16)) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (abs(vals[i]) != 16) continue;
                br.fill();
                const int n1 = min(__clz((int)~br.peek()), 24);
                br.skip(n1 + 1);
                br.fill();
                const int n = 4 + n1;
                const int mag = (1 << n) | (int)(br.peek() >> (32 - n));
                br.skip(n);
                vals[i] = vals[i] < 0 ? -mag : mag;
            }
        }

        const int pos = base + cw_i * dim;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (i < dim && pos + i < N_LINES) q[pos + i] = vals[i];

        // the next codeword, by selects: a branch here lets the compiler
        // split the loop into runs and codewords, and a lane whose run
        // ends would wait for the warp's longest run
        const bool next_run = ++cw_i >= ncw;
        run_i += next_run;
        if (run_i >= nr) break;
        cw_i = next_run ? 0 : cw_i;
        r = next_run ? r_next : r;
        r_next = (uint32_t)rr[min(run_i + 1, run_cols - 1)];
    }
}

// A block decodes LANES_PER_BLOCK lanes, LANES_PER_WARP of them in each
// of its warps (threads 0 .. LANES_PER_WARP - 1 of the warp); all its
// threads stage, zero and write back.
__global__ void spectral_decode_kernel(const uint8_t* __restrict__ au, int au_stride,
                                       const int32_t* __restrict__ bitpos0,
                                       const int32_t* __restrict__ runs, int run_cols,
                                       const int32_t* __restrict__ n_runs,
                                       const int32_t* __restrict__ table, int table_len,
                                       int32_t* __restrict__ quant, int lanes) {
    extern __shared__ __align__(16) char smem[];
    const int l0 = blockIdx.x * LANES_PER_BLOCK;
    const int nl = min(LANES_PER_BLOCK, lanes - l0);  // even: lanes = 2 * AUs
    // the table, the run programs, the AU rows, the output rows (layout of smem_bytes())
    char* runs_base = smem + align16(table_len * 4 + 16);
    char* au_base = runs_base + align16(LANES_PER_BLOCK * run_cols * 4 + 16);
    int32_t* out_s =
        reinterpret_cast<int32_t*>(au_base + align16((LANES_PER_BLOCK / 2) * au_stride + 16));
    const char* table_src = reinterpret_cast<const char*>(table);
    const char* runs_src = reinterpret_cast<const char*>(runs + (long)l0 * run_cols);
    const char* au_src = reinterpret_cast<const char*>(au + (long)(l0 >> 1) * au_stride);
    char* table_s = mirror(smem, table_src);
    char* runs_s = mirror(runs_base, runs_src);
    char* au_s = mirror(au_base, au_src);
    stage(table_s, table_src, table_len * 4);
    stage(runs_s, runs_src, nl * run_cols * 4);
    stage(au_s, au_src, (nl >> 1) * au_stride);
    asm volatile("cp.async.commit_group;\n" ::);

    const int t = threadIdx.x & 31;
    const int li = (threadIdx.x >> 5) * LANES_PER_WARP + t;  // this thread's lane in the block
    const bool live = t < LANES_PER_WARP && li < nl;
    const int bp0 = live ? bitpos0[l0 + li] : 0;
    const int nr = live ? n_runs[l0 + li] : 0;

    int4* o4 = reinterpret_cast<int4*>(out_s);
    for (int i = threadIdx.x; i < nl * (OUT_STRIDE / 4); i += blockDim.x) o4[i] = make_int4(0, 0, 0, 0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    if (live && nr > 0)
        decode_lane(reinterpret_cast<const int32_t*>(table_s),
                    reinterpret_cast<const int32_t*>(runs_s) + li * run_cols, run_cols, nr,
                    reinterpret_cast<const uint32_t*>(au_s + (li >> 1) * au_stride),
                    au_stride / 4, bp0, out_s + li * OUT_STRIDE);
    __syncthreads();

    // the block's output rows, coalesced 16-byte stores
    int4* q4 = reinterpret_cast<int4*>(quant + (long)l0 * N_LINES);
    for (int i = threadIdx.x; i < nl * (N_LINES / 4); i += blockDim.x)
        q4[i] = o4[(i / (N_LINES / 4)) * (OUT_STRIDE / 4) + i % (N_LINES / 4)];
}

}  // namespace

// au u8 [lanes / 2, au_stride]; bitpos, n_runs i32 [lanes]; runs i32
// [lanes, run_cols]; table i32 [table_len] (two-level); quant i32
// [lanes, 1024], written whole.
extern "C" int skt_spectral_decode(const uint8_t* au, int au_stride, const int32_t* bitpos,
                                   const int32_t* runs, int run_cols, const int32_t* n_runs,
                                   const int32_t* table, int table_len, int32_t* quant,
                                   int lanes, void* stream) {
    if (lanes <= 0) return 0;
    if (lanes % 2 || au_stride % 4 || run_cols <= 0) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(table_len, run_cols, au_stride);
    // raised once per size, outside any graph capture (the callers warm up first)
    static size_t smem_allowed = 48 * 1024;
    if (smem > smem_allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            spectral_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_allowed = smem;
    }
    const int blocks = (lanes + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK;
    spectral_decode_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        au, au_stride, bitpos, runs, run_cols, n_runs, table, table_len, quant, lanes);
    return (int)cudaGetLastError();
}
