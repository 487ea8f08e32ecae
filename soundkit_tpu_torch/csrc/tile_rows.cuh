// Staging of a block's rows between global and shared memory, for the
// scans that step through tiles (g726.cu, g722.cu, flac_lpc.cu).
//
// A block owns a few lanes; a lane's codes, samples or mask bytes are one
// row of the [B, N] input. The step loop of a scan must not touch global
// memory, so a tile of every row is copied in before the steps and the
// outputs are copied back after, all threads of the block side by side
// on neighbouring addresses.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

// wait for this thread's cp.async copies; a __syncthreads() after it
// makes every thread's copies visible to the block
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows x n bytes from global (row stride gs) into shared memory (row
// stride ds, a multiple of 4): cp.async by 4 bytes when the rows allow,
// else byte copies
template <int THREADS>
__device__ __forceinline__ void load_rows(uint8_t* dst, int ds, const uint8_t* src, long gs,
                                          int rows, int n) {
    if ((((uintptr_t)src | (uintptr_t)gs | (uintptr_t)n) & 3) == 0) {
        for (int r = 0; r < rows; ++r)
            for (int c = 4 * threadIdx.x; c < n; c += 4 * THREADS)
                cp_async4(dst + r * ds + c, src + r * gs + c);
    } else {
        for (int r = 0; r < rows; ++r)
            for (int c = threadIdx.x; c < n; c += THREADS) dst[r * ds + c] = src[r * gs + c];
    }
}

// the reverse, plain stores
template <int THREADS>
__device__ __forceinline__ void store_rows(uint8_t* dst, long gs, const uint8_t* src, int ds,
                                           int rows, int n) {
    if ((((uintptr_t)dst | (uintptr_t)gs | (uintptr_t)n) & 3) == 0) {
        for (int r = 0; r < rows; ++r)
            for (int c = 4 * threadIdx.x; c < n; c += 4 * THREADS)
                *reinterpret_cast<uint32_t*>(dst + r * gs + c) =
                    *reinterpret_cast<const uint32_t*>(src + r * ds + c);
    } else {
        for (int r = 0; r < rows; ++r)
            for (int c = threadIdx.x; c < n; c += THREADS) dst[r * gs + c] = src[r * ds + c];
    }
}

}  // namespace
