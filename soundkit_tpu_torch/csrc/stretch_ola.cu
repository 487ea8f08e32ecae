// K16: the overlap-add and window-square normalisation of the device phase
// vocoder: soundkit_tpu/ops/stretch.py::stretch_batch_device, the `* win` of the
// synthesis frames, the lax.scan `ola` of dynamic_update_slice adds, the divide
// by max(norm, 1e-8) and the crop to [FRAME/2, FRAME/2 + target) with its zero
// pad (XLA there, no Pallas kernel).
//
// Inputs: the synthesis frames f32 [B, T, F] (irfft output, before the window)
// and the window f32 [F]. Output: out f32 [B, target], in one launch:
//   out[b, j] = (sum over the frames t that cover J = start + j, ascending t,
//                of win[J - t hop] * frame[b, t, J - t hop])
//             / max(sum over the same t, ascending, of win[J - t hop]^2, 1e-8)
// Each product and sum is rounded alone (__fmul_rn, __fadd_rn; no FMA), both
// sums start from 0, the divide is IEEE (__fdiv_rn): the scan's order of
// operations, so the result equals the plain version bit for bit. Past the
// line (J >= hop (T-1) + F) and in a gap between frames (hop > F) no frame
// covers J: the sum is +0, the divisor 1e-8, and the output +0, as the
// reference's zero pad and its 0 / max(0, 1e-8).
//
// Bound on the card: bytes, each frame that covers the crop window read once
// and the output written once (1024 lanes x 174 of 348 frames x 2048 x 4 B in
// and 1024 x 165375 x 4 B out at the pitch shift's size: 2.14 GB, 0.64 ms at
// 3.35 TB/s). The design keeps enough of those bytes in flight:
// - a thread takes V adjacent outputs (a vector) of ROWS lanes; V (4, 2 or 1,
//   the wrapper's `k16_vector`) divides hop, F, start and the frames' and the
//   window's addresses, so the V samples of a vector share one cover and each
//   covering frame's segment is one aligned V-float load;
// - the cover is two 32-bit divisions a vector; the covering frames' loads,
//   CHUNK of them at a time (every frame that covers a sample at hop 960),
//   are all issued before the first add: ROWS x CHUNK x 4V bytes in flight a
//   thread (96 B at the pitch shift's size, 4 B before);
// - the divisor is formed in registers from the same window loads, once a
//   vector for its ROWS lanes: no second launch, no scratch;
// - the frames are read and the output written with streaming hints
//   (__ldcs, __stcs: each byte is touched once), the window through the
//   read-only cache;
// - a warp's outputs pass through shared memory so that each store writes 32
//   consecutive samples (an output row is not 16-byte aligned: target is odd
//   at the pitch shift's size).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 2;   // lanes a thread
constexpr int CHUNK = 3;  // covering frames loaded together

template <int V>
struct Vec {
    float x[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load_win(const float* p) {
    Vec<V> v;
    if constexpr (V == 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p));
        v.x[0] = a.x, v.x[1] = a.y, v.x[2] = a.z, v.x[3] = a.w;
    } else if constexpr (V == 2) {
        const float2 a = __ldg(reinterpret_cast<const float2*>(p));
        v.x[0] = a.x, v.x[1] = a.y;
    } else {
        v.x[0] = __ldg(p);
    }
    return v;
}

template <int V>
__device__ __forceinline__ Vec<V> load_stream(const float* p) {
    Vec<V> v;
    if constexpr (V == 4) {
        const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
        v.x[0] = a.x, v.x[1] = a.y, v.x[2] = a.z, v.x[3] = a.w;
    } else if constexpr (V == 2) {
        const float2 a = __ldcs(reinterpret_cast<const float2*>(p));
        v.x[0] = a.x, v.x[1] = a.y;
    } else {
        v.x[0] = __ldcs(p);
    }
    return v;
}

template <int V>
__device__ __forceinline__ void store_shared(float* p, const float* v) {
    if constexpr (V == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (V == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
        *p = v[0];
    }
}

// A block: THREADS vectors of V samples (THREADS V outputs) of ROWS lanes.
template <int V>
__global__ void __launch_bounds__(THREADS)
stretch_ola_kernel(const float* __restrict__ frames, const float* __restrict__ win,
                   float* __restrict__ out, int B, int T, int F, int hop, int start,
                   int target) {
    __shared__ __align__(16) float stage[THREADS * V * ROWS];
    const int lane = threadIdx.x & 31;
    const int j0 = (blockIdx.x * THREADS + threadIdx.x) * V;
    const int b0 = blockIdx.y * ROWS;
    const int J0 = start + j0;
    // the frames that cover J0 .. J0 + V - 1: t_lo .. t_hi, empty past the
    // line, in a gap, and for a vector past the target
    const int t_hi = j0 < target ? min(J0 / hop, T - 1) : -1;
    const int t_lo = J0 >= F ? (J0 - F) / hop + 1 : 0;
    // a lane past B reads lane B - 1 again and stores nothing
    const float* rows[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) rows[r] = frames + (size_t)min(b0 + r, B - 1) * T * F;

    float acc[ROWS][V], den[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
        den[e] = 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][e] = 0.f;
    }
    for (int t0 = t_lo; t0 <= t_hi; t0 += CHUNK) {
        Vec<V> w[CHUNK], f[ROWS][CHUNK];
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
            const int t = t0 + c;
            if (t <= t_hi) {
                const int i = J0 - t * hop;
                w[c] = load_win<V>(win + i);
#pragma unroll
                for (int r = 0; r < ROWS; ++r)
                    f[r][c] = load_stream<V>(rows[r] + (size_t)t * F + i);
            }
        }
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
            if (t0 + c <= t_hi) {
#pragma unroll
                for (int e = 0; e < V; ++e) {
                    const float wv = w[c].x[e];
                    den[e] = __fadd_rn(den[e], __fmul_rn(wv, wv));
#pragma unroll
                    for (int r = 0; r < ROWS; ++r)
                        acc[r][e] = __fadd_rn(acc[r][e], __fmul_rn(wv, f[r][c].x[e]));
                }
            }
        }
    }

    float* st = stage + (threadIdx.x >> 5) * (32 * V * ROWS);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        float q[V];
#pragma unroll
        for (int e = 0; e < V; ++e) q[e] = __fdiv_rn(acc[r][e], fmaxf(den[e], 1e-8f));
        store_shared<V>(st + r * 32 * V + lane * V, q);
    }
    __syncwarp();
    const int jw = j0 - lane * V;  // the warp's first sample
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        if (b0 + r >= B) break;
        float* o = out + (size_t)(b0 + r) * target + jw;
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const int s = k * 32 + lane;
            if (jw + s < target) __stcs(o + s, st[r * 32 * V + s]);
        }
    }
}

using Kernel = void (*)(const float*, const float*, float*, int, int, int, int, int, int);

Kernel pick(int V) {
    switch (V) {
        case 4: return stretch_ola_kernel<4>;
        case 2: return stretch_ola_kernel<2>;
        case 1: return stretch_ola_kernel<1>;
        default: return nullptr;
    }
}

}  // namespace

// V outputs a thread, as the wrapper's k16_vector chose it; refused
// (cudaErrorInvalidValue) unless V is 4, 2 or 1 and divides F, hop, start and
// the two input addresses.
extern "C" int skt_stretch_ola(const float* frames, const float* win, float* out, int B, int T,
                               int F, int hop, int start, int target, int V, void* stream) {
    if (B <= 0 || target <= 0) return 0;
    const Kernel kernel = pick(V);
    const long long slack = (long long)THREADS * V;
    if (kernel == nullptr || T <= 0 || F <= 0 || hop <= 0 || start < 0 || F % V || hop % V ||
        start % V || (uintptr_t)frames % (4 * V) || (uintptr_t)win % (4 * V) ||
        (long long)hop * (T - 1) + F >= (1LL << 31) ||
        (long long)start + target + slack >= (1LL << 31) || (B + ROWS - 1) / ROWS > 65535)
        return (int)cudaErrorInvalidValue;
    const int vectors = (target + V - 1) / V;
    const dim3 grid((unsigned)((vectors + THREADS - 1) / THREADS),
                    (unsigned)((B + ROWS - 1) / ROWS));
    kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(frames, win, out, B, T, F, hop, start,
                                                       target);
    return (int)cudaGetLastError();
}

// Registers, local (spilled) bytes, static shared bytes and resident blocks
// an SM of the V instance.
extern "C" int skt_stretch_ola_occupancy(int V, int* info) {
    const Kernel kernel = pick(V);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes attr;
    int rc = (int)cudaFuncGetAttributes(&attr, (const void*)kernel);
    if (rc != 0) return rc;
    int blocks = 0;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)kernel, THREADS,
                                                            0);
    info[0] = attr.numRegs;
    info[1] = (int)attr.localSizeBytes;
    info[2] = (int)attr.sharedSizeBytes;
    info[3] = blocks;
    return rc;
}
