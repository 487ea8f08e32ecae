// TNS all-pole filter over spectral positions.
//
// Replaces soundkit_tpu/ops/aac_batch.py::_tns_scan, a lax.scan over the
// 1024 spectral positions of every (lane, channel) row. Position j reads
// x = coef[perm[j]] (perm reverses the lines of downward filters), runs
// the order-20 all-pole recursion y = x - sum_k lpc[fid][k] * hist[k] when
// its filter id fid >= 0 (fid -1 passes x through), clears the history
// whenever the filter id changes, and stores y[j]; then out[i] = y[perm[i]],
// the reference's gather (for the parser's involutive perm it undoes the
// reversal; for any other perm it still matches the reference).
//
// What bounds it: the recursion. Each output feeds the next prediction,
// so a row is 1024 dependent steps of a 20-tap dot product; the bytes
// (three 4 KB rows in, one out) are small. Design: one thread per row
// with the 20-entry history in registers (fully unrolled), reading its
// row sequentially from device memory; y goes through a caller-owned
// scratch row that the same thread then gathers from. One thread per
// filter region would expose more parallelism; that is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int N_LINES = 1024;
constexpr int MAX_ORDER = 20;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) tns_filter_kernel(
    const float* __restrict__ coef, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ filt_id, const float* __restrict__ lpc,
    float* __restrict__ y, float* __restrict__ out, int rows, int n_filters) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= rows) return;
    const long o = (long)t * N_LINES;
    const float* lp = lpc + (long)t * n_filters * MAX_ORDER;

    float hist[MAX_ORDER];
#pragma unroll
    for (int k = 0; k < MAX_ORDER; ++k) hist[k] = 0.f;
    int prev = -1;
    for (int j = 0; j < N_LINES; ++j) {
        const int p = perm[o + j];
        const int fid = filt_id[o + j];
        float v = coef[o + p];
        if (fid != prev) {
#pragma unroll
            for (int k = 0; k < MAX_ORDER; ++k) hist[k] = 0.f;
        }
        if (fid >= 0) {
            const float* a = lp + min(fid, n_filters - 1) * MAX_ORDER;
            float pred = 0.f;
#pragma unroll
            for (int k = 0; k < MAX_ORDER; ++k) pred += a[k] * hist[k];
            v -= pred;
#pragma unroll
            for (int k = MAX_ORDER - 1; k > 0; --k) hist[k] = hist[k - 1];
            hist[0] = v;
        }
        prev = fid;
        y[o + j] = v;
    }
    for (int i = 0; i < N_LINES; ++i) out[o + i] = y[o + perm[o + i]];
}

}  // namespace

extern "C" int skt_tns_filter(const float* coef, const int32_t* perm,
                              const int32_t* filt_id, const float* lpc,
                              float* y, float* out, int rows, int n_filters,
                              void* stream) {
    const int blocks = (rows + THREADS - 1) / THREADS;
    tns_filter_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        coef, perm, filt_id, lpc, y, out, rows, n_filters);
    return (int)cudaGetLastError();
}
