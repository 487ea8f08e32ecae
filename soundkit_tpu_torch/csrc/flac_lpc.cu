// FLAC LPC reconstruction, wasted-bit shift and stereo decorrelation (K9).
//
// Replaces soundkit_tpu/ops/flac_lpc.py::flac_frame_device: there, a
// lax.scan over time carries a [rows, 32] history and every step sums
// history * coefficients over all 32 taps. Here a thread owns a channel
// row and runs
//
//     s[n] = r[n]                                          n < order
//     s[n] = r[n] + ((sum_k coef[k] * s[n-1-k]) >> shift)   otherwise
//
// with the history as a 32-deep ring in local memory. Everything is
// 64-bit and wraps as two's complement (unsigned multiply and add, the
// prediction's >> arithmetic), so that arbitrary int32 inputs give the
// reference's int64 result bit for bit, not only legal 16- and 24-bit
// streams. The sum runs to the row's last non-zero coefficient, which is
// the same sum: the reference's taps past it add zero.
//
// The two channels of a lane are neighbouring threads of one warp. After
// its step a thread shifts its sample by the wasted bits, takes its
// partner's by a shuffle and writes its own side of the decorrelation
// (left/side 8, right/side 9, mid/side 10), cut to int32 at the store;
// so no second pass and no 64-bit intermediate in memory. A warp runs to
// the largest block size among its valid lanes; samples past a lane's
// block size, and invalid lanes, are written as zero. Shifts are taken
// modulo 64.
//
// What bounds it: bytes (the plane in, the samples out) by the count;
// in this first design the serial chain of a row: 64-bit multiply-adds
// one after another, and loads and stores of 4 bytes a thread, T apart.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROWS_PER_BLOCK = 32;  // one warp: 16 lanes, both channels
constexpr int MAX_ORDER = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

typedef unsigned long long u64;
typedef long long i64;

__global__ void __launch_bounds__(ROWS_PER_BLOCK) flac_lpc_kernel(
    const int32_t* __restrict__ resw, const int32_t* __restrict__ coef,
    const int32_t* __restrict__ order, const int32_t* __restrict__ shift,
    const int32_t* __restrict__ wasted, const int32_t* __restrict__ assign,
    const int32_t* __restrict__ block_size, const bool* __restrict__ valid,
    int32_t* __restrict__ out, long rows, int T) {
    const long row = (long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x;
    const bool in_range = row < rows;
    const long r_ld = in_range ? row : 0;  // threads past the end compute on row 0, store nothing
    const long lane = r_ld >> 1;
    const int chan = (int)(r_ld & 1);

    u64 cf[MAX_ORDER];
    u64 hist[MAX_ORDER];
    int taps = 0;
#pragma unroll
    for (int k = 0; k < MAX_ORDER; ++k) {
        const int32_t c = coef[r_ld * MAX_ORDER + k];
        cf[k] = (u64)(i64)c;
        hist[k] = 0;
        if (c != 0) taps = k + 1;
    }
    const int ord = order[r_ld];
    const int sh = shift[r_ld] & 63;
    const int ws = wasted[r_ld] & 63;
    const int a = assign[lane];
    const int n_live = in_range && valid[lane] ? min(max(block_size[lane], 0), T) : 0;
    const int n_warp = __reduce_max_sync(FULL, n_live);

    const int32_t* r = resw + r_ld * T;
    int32_t* o = out + r_ld * T;
    for (int n = 0; n < n_warp; ++n) {
        u64 s = (u64)(i64)r[n];
        if (n >= ord) {
            u64 acc = 0;
            for (int k = 0; k < taps; ++k) acc += cf[k] * hist[(n - 1 - k) & (MAX_ORDER - 1)];
            s += (u64)((i64)acc >> sh);
        }
        hist[n & (MAX_ORDER - 1)] = s;

        const u64 mine = s << ws;
        const u64 other = __shfl_xor_sync(FULL, mine, 1);
        const u64 c0 = chan ? other : mine;
        const u64 c1 = chan ? mine : other;
        u64 v = mine;
        if (a == 10) {
            const u64 mid = (c0 << 1) | (c1 & 1);
            v = (u64)((i64)(chan ? mid - c1 : mid + c1) >> 1);
        } else if (a == 9 && chan == 0) {
            v = c1 + c0;
        } else if (a == 8 && chan == 1) {
            v = c0 - c1;
        }
        if (in_range) o[n] = n < n_live ? (int32_t)v : 0;
    }
    if (in_range)
        for (int n = n_warp; n < T; ++n) o[n] = 0;
}

}  // namespace

extern "C" int skt_flac_lpc(const int32_t* resw, const int32_t* coef, const int32_t* order,
                            const int32_t* shift, const int32_t* wasted, const int32_t* assign,
                            const int32_t* block_size, const bool* valid, int32_t* out, int L,
                            int T, void* stream) {
    if ((long)L * T == 0) return 0;
    const long rows = 2L * L;
    const unsigned blocks = (unsigned)((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    flac_lpc_kernel<<<blocks, ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        resw, coef, order, shift, wasted, assign, block_size, valid, out, rows, T);
    return (int)cudaGetLastError();
}
