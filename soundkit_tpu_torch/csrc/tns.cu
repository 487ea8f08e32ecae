// TNS all-pole filter over spectral positions.
//
// Replaces soundkit_tpu/ops/aac_batch.py::_tns_scan, a lax.scan over the
// 1024 spectral positions of every (lane, channel) row. Position j reads
// x = coef[perm[j]] (perm reverses the lines of downward filters), runs
// the order-20 all-pole recursion y = x - sum_k lpc[fid][k] * hist[k] when
// its filter id fid >= 0 (fid -1 passes x through), clears the history
// whenever the filter id changes, and stores y[j]; then out[i] = y[perm[i]],
// the reference's gather (for the parser's involutive perm it undoes the
// reversal; for any other perm it still matches the reference). Filter
// ids at or past n_filters use the last filter's taps.
//
// What bounds it: the bytes are 33 MB at B = 1024 stereo (coef, perm and
// filt_id in, the output out: about 0.010 ms at 3.35 TB/s); the operations
// (2 x 20 per filtered line) are negligible. But each filtered line
// depends on the previous one, so a row's longest segment -- a maximal
// run of one filter id, up to ~900 lines for a long window -- is a chain
// of dependent steps that no parallelism shortens.
// Design: one warp per row, four rows per 128-thread block.
// - The warp stages its row in shared memory with coalesced 16-byte loads
//   (coef, perm and filt_id; the LPC taps), and forms x[j] = coef[perm[j]]
//   there; the global scratch row of the earlier design is gone.
// - It finds the row's segments with ballots over the filter ids (a start
//   where the id differs from the previous line's, an end where it
//   differs from the next line's).
// - Every segment of the block's rows goes to its own thread, so the
//   segments of four rows run side by side in one warp. The thread keeps
//   the taps and the 20-entry history in registers, the history as a ring
//   whose rotation is unrolled (no register moves), and sums the taps
//   oldest first so that only the newest one sits on the dependent chain:
//   y = fma(-a[0], h[0], x - sum_{k=19..1} a[k] h[k]). y overwrites x in
//   place; pass-through lines keep x. A step is about 25 instructions for
//   one lane: with one long segment per row the recursion is bound by
//   issuing them, not by the chain.
// - The warp gathers out[i] = y[perm[i]] from shared memory and stores
//   it coalesced.
// Filter ids are compared as int16 (ids past 32767 count as 32767).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int N_LINES = 1024;
constexpr int MAX_ORDER = 20;
constexpr int ROWS = 4;
constexpr int THREADS = 32 * ROWS;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int smem_bytes(int n_filters) {
    // x/y and coef-then-segment-bounds (floats), perm and filt_id (int16), taps
    return ROWS * (2 * N_LINES * 4 + 2 * N_LINES * 2 + n_filters * MAX_ORDER * 4);
}

// Step u of a turn of the history ring: history k of this step sits in
// h[(R + k) % 20] with R = (20 - u) % 20, and y replaces the oldest entry.
template <int U>
__device__ __forceinline__ void tns_step(float (&h)[MAX_ORDER], const float (&a)[MAX_ORDER],
                                         float* __restrict__ xy, int j) {
    constexpr int R = (MAX_ORDER - U) % MAX_ORDER;
    float rest = 0.f;
#pragma unroll
    for (int k = MAX_ORDER - 1; k > 0; --k) rest = fmaf(a[k], h[(R + k) % MAX_ORDER], rest);
    const float y = fmaf(-a[0], h[R], xy[j] - rest);
    h[(R + MAX_ORDER - 1) % MAX_ORDER] = y;
    xy[j] = y;
}

template <int U>
__device__ __forceinline__ void tns_turn(float (&h)[MAX_ORDER], const float (&a)[MAX_ORDER],
                                         float* __restrict__ xy, int j, int steps) {
    if constexpr (U < MAX_ORDER) {
        if (U < steps) {
            tns_step<U>(h, a, xy, j + U);
            tns_turn<U + 1>(h, a, xy, j, steps);
        }
    }
}

// One segment [j, end) of a row: the all-pole recursion over xy in place,
// from a zero history, with taps a[0..19] (a[k] weighs the line k + 1
// back), in whole turns of the ring and then the rest of one.
__device__ __forceinline__ void run_segment(float* __restrict__ xy, int j, int end,
                                            const float* __restrict__ taps) {
    float a[MAX_ORDER];
    float h[MAX_ORDER];
#pragma unroll
    for (int k = 0; k < MAX_ORDER; ++k) {
        a[k] = taps[k];
        h[k] = 0.f;
    }
    for (; end - j >= MAX_ORDER; j += MAX_ORDER) tns_turn<0>(h, a, xy, j, MAX_ORDER);
    tns_turn<0>(h, a, xy, j, end - j);
}

__global__ void __launch_bounds__(THREADS) tns_filter_kernel(
    const float* __restrict__ coef, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ filt_id, const float* __restrict__ lpc,
    float* __restrict__ out, int rows, int n_filters) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* xy_all = reinterpret_cast<float*>(smem);
    float* buf_all = xy_all + ROWS * N_LINES;
    int16_t* perm_all = reinterpret_cast<int16_t*>(buf_all + ROWS * N_LINES);
    int16_t* fid_all = perm_all + ROWS * N_LINES;
    float* taps_all = reinterpret_cast<float*>(fid_all + ROWS * N_LINES);
    __shared__ int n_seg[ROWS];

    const int w = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int row = blockIdx.x * ROWS + w;
    float* xy = xy_all + w * N_LINES;
    float* buf = buf_all + w * N_LINES;
    int16_t* ps = perm_all + w * N_LINES;
    int16_t* fs = fid_all + w * N_LINES;
    const int n_taps = n_filters * MAX_ORDER;

    if (row < rows) {
        const long o = (long)row * N_LINES;
        const float4* c4 = reinterpret_cast<const float4*>(coef + o);
        const int4* p4 = reinterpret_cast<const int4*>(perm + o);
        const int4* f4 = reinterpret_cast<const int4*>(filt_id + o);
#pragma unroll
        for (int q = 0; q < N_LINES / 128; ++q) {
            const int i = lane + 32 * q;
            reinterpret_cast<float4*>(buf)[i] = c4[i];
            const int4 p = p4[i];
            const int4 f = f4[i];
            ps[4 * i] = (int16_t)(p.x & (N_LINES - 1));
            ps[4 * i + 1] = (int16_t)(p.y & (N_LINES - 1));
            ps[4 * i + 2] = (int16_t)(p.z & (N_LINES - 1));
            ps[4 * i + 3] = (int16_t)(p.w & (N_LINES - 1));
            fs[4 * i] = (int16_t)max(-1, min(f.x, 32767));
            fs[4 * i + 1] = (int16_t)max(-1, min(f.y, 32767));
            fs[4 * i + 2] = (int16_t)max(-1, min(f.z, 32767));
            fs[4 * i + 3] = (int16_t)max(-1, min(f.w, 32767));
        }
        for (int k = lane; k < n_taps; k += 32) taps_all[w * n_taps + k] = lpc[(long)row * n_taps + k];
        __syncwarp();
        for (int j = lane; j < N_LINES; j += 32) xy[j] = buf[ps[j]];
        __syncwarp();

        // segment bounds into buf (now free): starts, then ends
        int16_t* starts = reinterpret_cast<int16_t*>(buf);
        int16_t* ends = starts + N_LINES;
        const unsigned below = (1u << lane) - 1;
        int n_starts = 0;
        int n_ends = 0;
        for (int base = 0; base < N_LINES; base += 32) {
            const int j = base + lane;
            const int f = fs[j];
            const bool live = f >= 0;
            const bool st = live && (j == 0 || fs[j - 1] != f);
            const bool en = live && (j == N_LINES - 1 || fs[j + 1] != f);
            const unsigned ms = __ballot_sync(FULL, st);
            const unsigned me = __ballot_sync(FULL, en);
            if (st) starts[n_starts + __popc(ms & below)] = (int16_t)j;
            if (en) ends[n_ends + __popc(me & below)] = (int16_t)(j + 1);
            n_starts += __popc(ms);
            n_ends += __popc(me);
        }
        if (lane == 0) n_seg[w] = n_starts;  // every run has one start and one end
    } else if (lane == 0) {
        n_seg[w] = 0;
    }
    __syncthreads();

    // every segment of the block's rows to its own thread
    int total = 0;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) total += n_seg[r];
    for (int s = threadIdx.x; s < total; s += THREADS) {
        int r = 0;
        int k = s;
        while (k >= n_seg[r]) k -= n_seg[r++];
        const int16_t* starts = reinterpret_cast<const int16_t*>(buf_all + r * N_LINES);
        const int j0 = starts[k];
        const int fid = min((int)fid_all[r * N_LINES + j0], n_filters - 1);
        run_segment(xy_all + r * N_LINES, j0, starts[N_LINES + k],
                    taps_all + r * n_taps + fid * MAX_ORDER);
    }
    __syncthreads();

    if (row < rows) {
        float4* o4 = reinterpret_cast<float4*>(out + (long)row * N_LINES);
#pragma unroll
        for (int q = 0; q < N_LINES / 128; ++q) {
            const int i = lane + 32 * q;
            o4[i] = make_float4(xy[ps[4 * i]], xy[ps[4 * i + 1]], xy[ps[4 * i + 2]],
                                xy[ps[4 * i + 3]]);
        }
    }
}

}  // namespace

extern "C" int skt_tns_filter(const float* coef, const int32_t* perm,
                              const int32_t* filt_id, const float* lpc, float* out,
                              int rows, int n_filters, void* stream) {
    const int smem = smem_bytes(n_filters);
    static int configured = 0;  // the largest size set so far: the call costs host time
    if (smem > configured) {
        cudaError_t err = cudaFuncSetAttribute(tns_filter_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        configured = smem;
    }
    const int blocks = (rows + ROWS - 1) / ROWS;
    tns_filter_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        coef, perm, filt_id, lpc, out, rows, n_filters);
    return (int)cudaGetLastError();
}
