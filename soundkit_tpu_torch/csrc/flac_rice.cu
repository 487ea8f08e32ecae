// FLAC Rice / fixed-width residual decode into the residual plane (K8).
//
// Replaces soundkit_tpu/ops/flac_rice.py::flac_rice_plane_device: there,
// one lax.scan step decodes one code of every segment, the values and
// their targets pile up as [steps, N] arrays, and one scatter writes the
// plane. Here a thread owns a segment: it walks its own n codes to its
// own end and stores each value straight to plane[dest + i]. No
// intermediate, no scatter, no bound on the steps.
//
// Two launches on one stream: the fill (zeros, the 32 warm-up samples of
// each channel row, CONSTANT channels), then the segments, which
// overwrite it. Segments never overlap each other.
//
// A code is read from a 32-bit MSB-first window of the row's big-endian
// words; word indices past the row's end read its last word, as the
// reference clamps them. Rice: the unary quotient is the window's
// leading zeros; a window with 24 or more adds 24 and moves on 24 bits;
// then k remainder bits from a second window, and the zigzag fold in
// wrapping 32-bit arithmetic. Fixed width (k < 0, width -k - 1 in
// 0..32): one sign-extended read. A value whose index falls outside the
// plane is not written. A quotient that runs into a zero window on the
// row's last word never ends: the segment stops there (the reference
// stops at its step bound with the same values written).
//
// The host walk emits k in 0..31 and bit offsets >= 0. Outside that the
// kernel and the plain version still agree with each other: a Rice
// parameter above 31 reads 31 remainder bits (and advances by its own
// value), a negative offset starts at bit 0.
//
// What bounds it: bytes (the words and the segment table in, the plane
// out once by the fill and once more by the segments). This first design
// is not near that bound: a thread's stores are 4 bytes each, n apart
// from its neighbour's, and every window costs two word loads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int FILL_THREADS = 256;
constexpr int SEG_THREADS = 128;

// grid: x = channel row (frame row * 2 + channel) of the plane
__global__ void __launch_bounds__(FILL_THREADS) flac_fill_kernel(
    const int32_t* __restrict__ warm, const int32_t* __restrict__ cflag,
    const int32_t* __restrict__ cval, int32_t* __restrict__ plane, int stride) {
    const long row = blockIdx.x;
    int32_t* out = plane + row * stride;
    const bool is_const = cflag[row] == 1;
    const int32_t cv = is_const ? cval[row] : 0;
    const int32_t* w = warm + row * 32;
    for (int pos = threadIdx.x; pos < stride; pos += FILL_THREADS)
        out[pos] = is_const ? cv : (pos < 32 ? w[pos] : 0);
}

struct BitRow {
    const uint32_t* words;
    int last;  // index of the row's last word

    __device__ __forceinline__ uint32_t window(int bitpos) const {
        const int wi = bitpos >> 5;
        const int sh = bitpos & 31;
        const uint32_t w0 = words[min(wi, last)];
        if (sh == 0) return w0;
        const uint32_t w1 = words[min(wi + 1, last)];
        return (w0 << sh) | (w1 >> (32 - sh));
    }
};

__global__ void __launch_bounds__(SEG_THREADS) flac_rice_kernel(
    const uint32_t* __restrict__ words, int W, const int32_t* __restrict__ seg_lane,
    const int32_t* __restrict__ seg_bitoff, const int32_t* __restrict__ seg_k,
    const int32_t* __restrict__ seg_n, const int32_t* __restrict__ seg_dest, int N,
    int32_t* __restrict__ plane, long total) {
    const int s = blockIdx.x * SEG_THREADS + threadIdx.x;
    if (s >= N) return;
    const int n = seg_n[s];
    if (n <= 0) return;
    const BitRow row{words + (long)seg_lane[s] * W, W - 1};
    const int sk = seg_k[s];
    const long dest = seg_dest[s];
    int bitpos = max(seg_bitoff[s], 0);

    auto put = [&](int i, int32_t v) {
        const long t = dest + i;
        if (t >= 0 && t < total) plane[t] = v;
    };

    if (sk < 0) {
        const int width = -sk - 1;
        for (int i = 0; i < n; ++i, bitpos += width) {
            int32_t v = 0;
            if (width >= 1 && width <= 32) v = (int32_t)row.window(bitpos) >> (32 - width);
            put(i, v);
        }
        return;
    }
    const int k = min(sk, 31);
    for (int i = 0; i < n; ++i) {
        uint32_t q = 0;
        uint32_t win = row.window(bitpos);
        int lead = __clz((int)win);
        while (lead >= 24) {
            if (win == 0 && (bitpos >> 5) >= W - 1) return;  // the words are spent
            q += 24;
            bitpos += 24;
            win = row.window(bitpos);
            lead = __clz((int)win);
        }
        q += (uint32_t)lead;
        const uint32_t rem = k == 0 ? 0u : row.window(bitpos + lead + 1) >> (32 - k);
        const uint32_t zz = (q << k) | rem;
        put(i, (int32_t)(zz >> 1) ^ -(int32_t)(zz & 1));
        bitpos += lead + 1 + sk;
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
    flac_rice_kernel<<<(N + SEG_THREADS - 1) / SEG_THREADS, SEG_THREADS, 0, (cudaStream_t)stream>>>(
        words, W, seg_lane, seg_bitoff, seg_k, seg_n, seg_dest, N, plane,
        2L * NL * stride);
    return (int)cudaGetLastError();
}
