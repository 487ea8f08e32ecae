// FLAC Rice / fixed-width residual decode into the residual plane (K8).
//
// Replaces soundkit_tpu/ops/flac_rice.py::flac_rice_plane_device: there,
// one lax.scan step decodes one code of every segment, the values and
// their targets pile up as [steps, N] arrays, and one scatter writes the
// plane. Here a thread walks one segment's codes to its own end, and its
// warp writes them out.
//
// Two launches on one stream: the fill (zeros, the 32 warm-up samples of
// each channel row, CONSTANT channels), then the segments, which
// overwrite it. Segments never overlap each other; a segment may read any
// row of the words and write any flat range of the plane, in any order.
//
// What bounds it: bytes (the frame words and the segment table in, the
// plane out once by the fill and once more where the segments land). So:
//
// - The fill writes 16 bytes a store where the plane's rows allow (stride
//   a multiple of 4), one word a store otherwise.
// - A segment's bits are read through a 64-bit window in registers,
//   refilled one word at a time, the next word loaded one refill ahead:
//   a load per 32 bits consumed. A Rice code's unary quotient is the
//   leading zeros of the window's top word (a window with 24 or more adds
//   24 and moves on 24 bits); its k remainder bits come from the same
//   window; then the zigzag fold in wrapping 32-bit arithmetic. A fixed
//   width code (k < 0, width -k - 1) is one sign-extended read.
// - A warp takes 32 segments, one a thread. Each thread decodes up to
//   CHUNK values into its row of shared memory; then the warp writes each
//   segment's run with its 32 threads on neighbouring addresses,
//   dropping targets outside the plane. A segment longer than CHUNK
//   takes more rounds of the same loop.
//
// The words are read as the reference reads them: a row's word index
// past its end reads its last word; a flat index below 0 (a negative bit
// offset) counts from the end of all rows, and below -NL * W reads
// 0xFFFFFFFF, as jnp.take does. A Rice parameter of 32 or more follows
// XLA's 32-bit shifts: q << k is 0, so k = 32 gives the remainder window
// itself and k > 32 gives 0; the position still advances by lead + 1 + k.
// A quotient that runs into a zero window on the row's last word never
// ends: the segment stops there (the reference stops at its step bound
// with the same values written).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int FILL_THREADS = 256;
constexpr int SEG_WARPS = 4;           // warps a block, 32 segments each
constexpr int CHUNK = 32;              // values a segment decodes before its warp writes them
constexpr int CS = CHUNK + 1;          // a thread's row in shared memory: odd, no bank conflict
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr size_t SEG_SMEM = sizeof(int32_t) * SEG_WARPS * 32 * CS;

typedef unsigned long long u64;

// grid: x = channel row (frame row * 2 + channel) of the plane
__global__ void __launch_bounds__(FILL_THREADS) flac_fill_kernel(
    const int32_t* __restrict__ warm, const int32_t* __restrict__ cflag,
    const int32_t* __restrict__ cval, int32_t* __restrict__ plane, int stride) {
    const long row = blockIdx.x;
    int32_t* out = plane + row * stride;
    const bool is_const = cflag[row] == 1;
    const int32_t cv = is_const ? cval[row] : 0;
    const int32_t* w = warm + row * 32;
    auto at = [&](int pos) { return is_const ? cv : (pos < 32 ? w[pos] : 0); };
    if ((stride & 3) == 0 && ((uintptr_t)plane & 15) == 0) {
        for (int g = threadIdx.x; g < stride / 4; g += FILL_THREADS)
            *reinterpret_cast<int4*>(out + 4 * g) =
                make_int4(at(4 * g), at(4 * g + 1), at(4 * g + 2), at(4 * g + 3));
    } else {
        for (int pos = threadIdx.x; pos < stride; pos += FILL_THREADS) out[pos] = at(pos);
    }
}

// MSB-first bits of one segment's row: ``win`` holds ``nbits`` >= 32 of
// them from ``bitpos`` on, ``next`` the word after them.
struct Reader {
    const uint32_t* words;
    long base, n_flat;  // the row's first flat index, NL * W
    int last;           // the row's last word index, W - 1
    u64 win;
    int nbits, nw, bitpos;
    uint32_t next;

    __device__ __forceinline__ uint32_t word(int i) const {
        const long f = base + min(i, last);
        if (f >= 0 && f < n_flat) return __ldg(words + f);
        if (f < 0 && f >= -n_flat) return __ldg(words + f + n_flat);
        return 0xFFFFFFFFu;
    }
    __device__ __forceinline__ void seek(int pos) {
        bitpos = pos;
        const int wi = pos >> 5, sh = pos & 31;
        win = (((u64)word(wi) << 32) | word(wi + 1)) << sh;
        nbits = 64 - sh;
        nw = wi + 2;
        next = word(nw);
    }
    __device__ __forceinline__ uint32_t top() const { return (uint32_t)(win >> 32); }
    // move on c bits, 0 <= c <= 32
    __device__ __forceinline__ void skip(int c) {
        win <<= c;
        nbits -= c;
        bitpos += c;
        if (nbits < 32) {
            win |= (u64)next << (32 - nbits);
            nbits += 32;
            next = word(++nw);
        }
    }
    // move on c >= 0 bits
    __device__ __forceinline__ void advance(int c) {
        if (c <= 32)
            skip(c);
        else
            seek(bitpos + c);
    }
};

__global__ void __launch_bounds__(SEG_WARPS * 32) flac_rice_kernel(
    const uint32_t* __restrict__ words, int NL, int W, const int32_t* __restrict__ seg_lane,
    const int32_t* __restrict__ seg_bitoff, const int32_t* __restrict__ seg_k,
    const int32_t* __restrict__ seg_n, const int32_t* __restrict__ seg_dest, int N,
    int32_t* __restrict__ plane, long total) {
    extern __shared__ int32_t chunk[];  // [SEG_WARPS * 32][CS]
    const int lane = threadIdx.x & 31;
    int32_t* mine = chunk + threadIdx.x * CS;
    const int32_t* warp_rows = chunk + (threadIdx.x - lane) * CS;
    const int s = blockIdx.x * SEG_WARPS * 32 + threadIdx.x;

    const bool has = s < N;
    int n = has ? seg_n[s] : 0;
    const int sk = has ? seg_k[s] : 0;
    const long dest = has ? seg_dest[s] : 0;
    Reader rd;
    rd.words = words;
    rd.base = (long)(has ? seg_lane[s] : 0) * W;
    rd.n_flat = (long)NL * W;
    rd.last = W - 1;
    if (n > 0) rd.seek(seg_bitoff[s]);

    const int width = -sk - 1;   // fixed-width codes: sk < 0
    int done = 0;                // codes decoded
    while (__any_sync(FULL, done < n)) {
        const int from = done;
        while (done < n && done - from < CHUNK) {
            int32_t v;
            if (sk < 0) {
                v = width >= 1 && width <= 32 ? (int32_t)rd.top() >> (32 - width) : 0;
                rd.advance(width);
            } else {
                uint32_t q = 0;
                int lead = __clz((int)rd.top());
                while (lead >= 24) {
                    if (rd.top() == 0 && (rd.bitpos >> 5) >= W - 1) break;  // the words are spent
                    q += 24;
                    rd.skip(24);
                    lead = __clz((int)rd.top());
                }
                if (lead >= 24) {  // never ends: the segment stops here
                    n = done;
                    break;
                }
                q += (uint32_t)lead;
                rd.skip(lead + 1);
                const uint32_t rwin = rd.top();
                const uint32_t rem = sk == 0 ? 0u : sk < 32 ? rwin >> (32 - sk) : sk == 32 ? rwin : 0u;
                const uint32_t zz = (sk < 32 ? q << sk : 0u) | rem;
                v = (int32_t)(zz >> 1) ^ -(int32_t)(zz & 1);
                rd.advance(sk);
            }
            mine[done - from] = v;
            ++done;
        }
        __syncwarp();
        // each segment's run, 32 threads on neighbouring addresses
        const int cnt = done - from;
        const long at = dest + from;
        for (int j = 0; j < 32; ++j) {
            const int c = __shfl_sync(FULL, cnt, j);
            const long d = __shfl_sync(FULL, at, j);
            const int32_t* src = warp_rows + j * CS;
            for (int i = lane; i < c; i += 32) {
                const long tgt = d + i;
                if (tgt >= 0 && tgt < total) plane[tgt] = src[i];
            }
        }
        __syncwarp();
    }
}

}  // namespace

extern "C" int skt_flac_rice_plane(const uint32_t* words, int NL, int W, const int32_t* seg_lane,
                                   const int32_t* seg_bitoff, const int32_t* seg_k,
                                   const int32_t* seg_n, const int32_t* seg_dest, int N,
                                   const int32_t* warm, const int32_t* cflag, const int32_t* cval,
                                   int32_t* plane, int stride, void* stream) {
    if (NL == 0) return 0;
    flac_fill_kernel<<<2 * NL, FILL_THREADS, 0, (cudaStream_t)stream>>>(
        warm, cflag, cval, plane, stride);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess || N == 0) return (int)rc;
    rc = cudaFuncSetAttribute(flac_rice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SEG_SMEM);
    if (rc != cudaSuccess) return (int)rc;
    constexpr int per_block = SEG_WARPS * 32;
    flac_rice_kernel<<<(N + per_block - 1) / per_block, per_block, SEG_SMEM,
                       (cudaStream_t)stream>>>(words, NL, W, seg_lane, seg_bitoff, seg_k, seg_n,
                                               seg_dest, N, plane, 2L * NL * stride);
    return (int)cudaGetLastError();
}
