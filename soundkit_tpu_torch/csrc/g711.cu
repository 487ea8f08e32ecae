// G.711 mu-law / A-law decode with a per-lane law.
//
// Replaces soundkit_tpu/ops/pallas_kernels.py::g711_decode_pallas (K3):
// branch-free expansion of 8-bit codes [B, N] into int16 PCM, the law
// chosen per lane by is_alaw[b] != 0. It also fuses the validity mask
// of the telephony step (soundkit_tpu/models/telephony_batch.py, the
// jnp.where(valid, pcm, 0) after the expansion): with a counts pointer,
// position j of lane b is 0 from j = counts[b] on.
//
// What bounds it: bytes, and the launch. One byte in and two out per
// code, a few integer operations between; 2 M codes (B = 1024, N = 2048)
// are 6 MB of traffic, under two microseconds at the card's bandwidth,
// and launching any grid of this size takes about as long
// (skt_g711_launch_floor launches an empty kernel on the same grid, to
// measure that share). The first design (one thread a code over the
// flattened grid: a one-byte load and a two-byte store each, a 64-bit
// division for the row, the lane's law and count loaded per code) moved
// 0.9 TB/s in 0.0068 ms. This one gives a thread VEC = 16 neighbouring
// codes of one row: one 16-byte load, the expansion 16 times in
// registers, two 16-byte stores; it takes 0.0036 ms, 0.0012 of them the
// empty grid's (an H100 80GB HBM3 at a 700 W power limit). A block is
// one stretch of one row (the row is blockIdx.x, so no division), and
// reads the row's law and count once a thread. The codes are read in
// place from the telephony wire, wherever the caller's view starts: a
// row's first codes up to a 16-byte boundary and its last N mod 16 are
// expanded one by one, by the block's first threads, and where a row's
// output is not 16-byte aligned behind its head (a view at an odd
// offset) the stores are by sample.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int VEC = 16;  // codes a thread

__device__ __forceinline__ int decode_mulaw(int code) {
    const int s = 255 - code;
    const int mag = (((s & 0x0F) << 3) + 0x84) << ((s & 0x70) >> 4);
    return (s & 0x80) ? 0x84 - mag : mag - 0x84;
}

__device__ __forceinline__ int decode_alaw(int code) {
    const int s = code ^ 0x55;
    const int seg = (s & 0x70) >> 4;
    int mag = (s & 0x0F) << 4;
    mag = seg == 0 ? mag + 8 : (mag + 0x108) << (seg - 1);
    return (s & 0x80) ? mag : -mag;
}

// grid: x = the row, y = stretches of THREADS * VEC codes of it
__global__ void __launch_bounds__(THREADS) g711_decode_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ is_alaw,
    const int32_t* __restrict__ counts, int16_t* __restrict__ out, int N) {
    const int b = blockIdx.x;
    const int t = blockIdx.y * THREADS + threadIdx.x;  // thread of the row
    const uint8_t* row = codes + (long)b * N;
    int16_t* pcm = out + (long)b * N;
    const int n_valid = counts == nullptr ? N : counts[b];
    const bool alaw = is_alaw[b] != 0;
    auto expand = [&](int j, int code) {
        return j < n_valid ? (alaw ? decode_alaw(code) : decode_mulaw(code)) : 0;
    };

    // [0, head) up to the first 16-byte boundary, then chunks of VEC, then the tail
    const int head = min(N, (int)(-(uintptr_t)row & (VEC - 1)));
    const int chunks = (N - head) / VEC;
    const int tail = head + chunks * VEC;
    if (t < chunks) {
        const int j0 = head + t * VEC;
        uint4 in = make_uint4(0, 0, 0, 0);
        if (j0 < n_valid) in = *reinterpret_cast<const uint4*>(row + j0);
        const uint32_t w[4] = {in.x, in.y, in.z, in.w};
        uint32_t o[VEC / 2];
#pragma unroll
        for (int i = 0; i < VEC; i += 2) {
            const int lo = expand(j0 + i, (w[i / 4] >> (8 * (i % 4))) & 0xFF);
            const int hi = expand(j0 + i + 1, (w[i / 4] >> (8 * (i % 4) + 8)) & 0xFF);
            o[i / 2] = (uint32_t)(lo & 0xFFFF) | ((uint32_t)hi << 16);
        }
        if (((uintptr_t)(pcm + j0) & 15) == 0) {
            uint4* dst = reinterpret_cast<uint4*>(pcm + j0);
            dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
            dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
        } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) pcm[j0 + i] = (int16_t)(o[i / 2] >> (16 * (i % 2)));
        }
    }
    if (t < head) pcm[t] = (int16_t)expand(t, row[t]);
    if (t < N - tail) pcm[tail + t] = (int16_t)expand(tail + t, row[tail + t]);
}

__global__ void __launch_bounds__(THREADS) empty_kernel() {}

dim3 grid_of(int B, int N) {
    const int per_row = (N + VEC - 1) / VEC;  // at least the threads a head and a tail take
    return dim3((unsigned)B, (unsigned)max(1, (per_row + THREADS - 1) / THREADS));
}

}  // namespace

extern "C" int skt_g711_decode(const uint8_t* codes, const int32_t* is_alaw,
                               const int32_t* counts, int16_t* out, int B, int N,
                               void* stream) {
    if ((long)B * N == 0) return 0;
    g711_decode_kernel<<<grid_of(B, N), THREADS, 0, (cudaStream_t)stream>>>(
        codes, is_alaw, counts, out, N);
    return (int)cudaGetLastError();
}

// An empty kernel on skt_g711_decode's grid: what the launch alone costs.
extern "C" int skt_g711_launch_floor(int B, int N, void* stream) {
    if ((long)B * N == 0) return 0;
    empty_kernel<<<grid_of(B, N), THREADS, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
