// Mamba2 SSD chunked-scan kernel (K5), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_ssd_kernel` (src/repro/kernels/ssd_scan.py,
// reached through `ssd_scan_bhtpn` and `ops.ssd_scan`).  Per (b, h) row and
// per chunk of Q steps, with x (Q, P), dt (Q), the head's decay rate A,
// B and C (Q, N) and the (P, N) f32 state S carried from the previous chunk:
//
//     a_cum = cumsum(dt * A)
//     L[i, j] = exp(a_cum[i] - a_cum[j]) for j <= i, else 0
//     y = ((C B^T) o L) (dt x) + (C o exp(a_cum)) S^T
//     S = exp(a_cum[Q-1]) S + (dt x o exp(a_cum[Q-1] - a_cum))^T B
//
// all in f32 from inputs cast once; y in the input dtype.
//
// Design.  The TPU kernel carries S in VMEM scratch across a sequential
// grid axis over chunks.  Here one block owns one (b, h) row and walks its
// chunks in order with S in shared memory (P x (N + 1) floats, 33 KB at
// P 64, N 128).  At the model's chunk of 256, L alone would be 256 KB, so
// the chunk is cut into 64-row tiles: for each query tile i, C_i is staged
// once, the incoming-state term is taken from S, and the key tiles j <= i
// are walked: G = (C_i B_j^T) o L_ij (64 x 64, in shared memory), then
// y_i += G dtx_j.  At the diagonal tile j == i the block also adds tile j's
// share of the new state into registers; S is overwritten only after every
// row of the chunk has read the old one.  a_cum comes from a block-wide
// prefix sum (per-thread runs, a warp scan, a scan of the warp totals).
// 256 threads as 16 x 16; each thread owns 4 rows x P/16 columns of y and
// 4 x 4 entries of G; rows of S, C and B are padded to N + 1 floats so that
// 16 lanes reading 16 rows at one column hit 16 banks.
//
// Bound on this card: at mamba2_130m's full-width prefill (BH 96, T 512,
// P 64, N 128, chunk 256, bf16 as the model runs it) x, B, C and y are 38 MB,
// 11 us at 3.35 TB/s, and the chunked algebra is ~4 GFLOP, 4 us at the bf16
// tensor rate: bytes bound it.  This kernel does its products as f32 FMAs
// from shared memory, with one block per row (96 blocks, under one wave of
// 132 SMs), so it is far from either; tensor-core tiles and more blocks per
// row (chunk states in a first pass, their recurrence in a second) are later
// work.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;           // rows of a query or key tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 1024;      // longest chunk
constexpr int kGL = kT + 1;      // padded row of the G tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

template <int P, int N>
constexpr size_t smem_floats(int q) {
    // S, C tile, B tile (rows N + 1), dtx tile, G tile, a_cum, decay to end, scan scratch
    return (size_t)P * (N + 1) + 2 * (size_t)kT * (N + 1) + (size_t)kT * P + (size_t)kT * kGL +
           2 * (size_t)q + kWarps;
}

// Inclusive prefix sum of dt[i] * A over i < q into out; ends with a barrier.
__device__ void chunk_cumsum(const float* __restrict__ dt, float A, int q, float* out,
                             float* red) {
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int per = (q + kThreads - 1) / kThreads;
    const int lo = min(tid * per, q), hi = min(lo + per, q);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
        run += dt[i] * A;
        out[i] = run;
    }
    float incl = run;  // inclusive scan of the per-thread totals within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
    }
    if (lane == 31) red[warp] = incl;
    __syncthreads();
    float offset = incl - run;
    for (int w = 0; w < warp; ++w) offset += red[w];
    for (int i = lo; i < hi; ++i) out[i] += offset;
    __syncthreads();
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ b,
                const T* __restrict__ c, T* __restrict__ y, int t, int q) {
    constexpr int NL = N + 1;
    constexpr int RC = P / 16;                                 // y columns a thread owns
    constexpr int SE = (P * N + kThreads - 1) / kThreads;      // state entries a thread owns
    extern __shared__ float smem[];
    float* st = smem;              // P x NL: the carried state
    float* cs = st + P * NL;       // kT x NL: C of the query tile
    float* bs = cs + kT * NL;      // kT x NL: B of the key tile
    float* xs = bs + kT * NL;      // kT x P: dt * x of the key tile
    float* gs = xs + kT * P;       // kT x kGL: (C B^T) o L
    float* acum = gs + kT * kGL;   // q
    float* d2e = acum + q;         // q: exp(a_cum[q-1] - a_cum)
    float* red = d2e + q;          // kWarps

    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const size_t row0 = (size_t)blockIdx.x * t;
    const float A = a[blockIdx.x];
    const T* xg = x + row0 * P;
    const T* bg = b + row0 * N;
    const T* cg = c + row0 * N;
    const float* dtg = dt + row0;
    T* yg = y + row0 * P;
    const int nt = (q + kT - 1) / kT;

    for (int e = tid; e < P * NL; e += kThreads) st[e] = 0.f;

    for (int c0 = 0; c0 < t; c0 += q) {
        chunk_cumsum(dtg + c0, A, q, acum, red);
        const float total = acum[q - 1];
        for (int i = tid; i < q; i += kThreads) d2e[i] = expf(total - acum[i]);
        float sacc[SE];
#pragma unroll
        for (int k = 0; k < SE; ++k) sacc[k] = 0.f;

        for (int it = 0; it < nt; ++it) {
            const int i0 = it * kT;
            __syncthreads();  // earlier readers of cs (and of d2e's writers) are done
            for (int e = tid; e < kT * N; e += kThreads) {
                const int r = e / N, n = e % N;
                cs[r * NL + n] = i0 + r < q ? to_f32(cg[(size_t)(c0 + i0 + r) * N + n]) : 0.f;
            }
            __syncthreads();

            // incoming-state term: exp(a_cum[row]) * sum_n C[row, n] S[col, n]
            float yacc[4][RC];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int cc = 0; cc < RC; ++cc) yacc[r][cc] = 0.f;
#pragma unroll 4
            for (int n = 0; n < N; ++n) {
                float cv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * NL + n];
#pragma unroll
                for (int cc = 0; cc < RC; ++cc) {
                    const float sv = st[(tx + 16 * cc) * NL + n];
#pragma unroll
                    for (int r = 0; r < 4; ++r) yacc[r][cc] = fmaf(cv[r], sv, yacc[r][cc]);
                }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int row = i0 + ty + 16 * r;
                const float dfs = row < q ? expf(acum[row]) : 0.f;
#pragma unroll
                for (int cc = 0; cc < RC; ++cc) yacc[r][cc] *= dfs;
            }

            for (int jt = 0; jt <= it; ++jt) {
                const int j0 = jt * kT;
                __syncthreads();  // earlier readers of bs, xs, gs are done
                for (int e = tid; e < kT * N; e += kThreads) {
                    const int r = e / N, n = e % N;
                    bs[r * NL + n] = j0 + r < q ? to_f32(bg[(size_t)(c0 + j0 + r) * N + n]) : 0.f;
                }
                for (int e = tid; e < kT * P; e += kThreads) {
                    const int r = e / P, p = e % P;
                    xs[e] = j0 + r < q
                                ? to_f32(xg[(size_t)(c0 + j0 + r) * P + p]) * dtg[c0 + j0 + r]
                                : 0.f;
                }
                __syncthreads();

                float g[4][4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int s = 0; s < 4; ++s) g[r][s] = 0.f;
#pragma unroll 4
                for (int n = 0; n < N; ++n) {
                    float cv[4], bv[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * NL + n];
#pragma unroll
                    for (int s = 0; s < 4; ++s) bv[s] = bs[(tx + 16 * s) * NL + n];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int s = 0; s < 4; ++s) g[r][s] = fmaf(cv[r], bv[s], g[r][s]);
                }
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int s = 0; s < 4; ++s) {
                        const int row = i0 + ty + 16 * r, col = j0 + tx + 16 * s;
                        const bool keep = row >= col && row < q;
                        gs[(ty + 16 * r) * kGL + tx + 16 * s] =
                            keep ? g[r][s] * expf(acum[row] - acum[col]) : 0.f;
                    }
                __syncthreads();

                // y_i += G dtx_j
#pragma unroll 4
                for (int s = 0; s < kT; ++s) {
                    float gv[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r) gv[r] = gs[(ty + 16 * r) * kGL + s];
#pragma unroll
                    for (int cc = 0; cc < RC; ++cc) {
                        const float xv = xs[s * P + tx + 16 * cc];
#pragma unroll
                        for (int r = 0; r < 4; ++r) yacc[r][cc] = fmaf(gv[r], xv, yacc[r][cc]);
                    }
                }

                if (jt == it) {  // tile j's share of the new state
                    const int rows = min(kT, q - j0);
#pragma unroll
                    for (int k = 0; k < SE; ++k) {
                        const int e = tid + k * kThreads;
                        if (e < P * N) {
                            const int p = e / N, n = e % N;
                            float acc = sacc[k];
                            for (int s = 0; s < rows; ++s)
                                acc = fmaf(xs[s * P + p] * d2e[j0 + s], bs[s * NL + n], acc);
                            sacc[k] = acc;
                        }
                    }
                }
            }

#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int row = i0 + ty + 16 * r;
                if (row >= q) continue;
#pragma unroll
                for (int cc = 0; cc < RC; ++cc)
                    yg[(size_t)(c0 + row) * P + tx + 16 * cc] = from_f32<T>(yacc[r][cc]);
            }
        }

        __syncthreads();  // every row of the chunk has read the old state
        const float decay = expf(total);
#pragma unroll
        for (int k = 0; k < SE; ++k) {
            const int e = tid + k * kThreads;
            if (e < P * N) {
                const int p = e / N, n = e % N;
                st[p * NL + n] = fmaf(decay, st[p * NL + n], sacc[k]);
            }
        }
        __syncthreads();  // the new state is whole before the next chunk reads it
    }
}

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* a, const void* b, const void* c,
           void* y, int64_t bh, int64_t t, int64_t q, cudaStream_t stream) {
    // The shared-memory attribute belongs to each device's context: set it
    // once per device, for the longest chunk, on its first launch.
    constexpr int kMaxDevices = 64;
    static bool configured[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!configured[dev]) {
        err = cudaFuncSetAttribute(ssd_scan_kernel<T, P, N>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)(sizeof(float) * smem_floats<P, N>(kMaxQ)));
        if (err != cudaSuccess) return (int)err;
        configured[dev] = true;
    }
    const size_t smem = sizeof(float) * smem_floats<P, N>((int)q);
    ssd_scan_kernel<T, P, N><<<(unsigned)bh, kThreads, smem, stream>>>(
        static_cast<const T*>(x), dt, a, static_cast<const T*>(b), static_cast<const T*>(c),
        static_cast<T*>(y), (int)t, (int)q);
    return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(const void* x, const float* dt, const float* a, const void* b, const void* c,
               void* y, int64_t bh, int64_t t, int64_t n, int64_t q, cudaStream_t stream) {
    switch (n) {
        case 8: return launch<T, P, 8>(x, dt, a, b, c, y, bh, t, q, stream);
        case 16: return launch<T, P, 16>(x, dt, a, b, c, y, bh, t, q, stream);
        case 32: return launch<T, P, 32>(x, dt, a, b, c, y, bh, t, q, stream);
        case 64: return launch<T, P, 64>(x, dt, a, b, c, y, bh, t, q, stream);
        case 128: return launch<T, P, 128>(x, dt, a, b, c, y, bh, t, q, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
int dispatch_p(const void* x, const float* dt, const float* a, const void* b, const void* c,
               void* y, int64_t bh, int64_t t, int64_t p, int64_t n, int64_t q,
               cudaStream_t stream) {
    switch (p) {
        case 16: return dispatch_n<T, 16>(x, dt, a, b, c, y, bh, t, n, q, stream);
        case 32: return dispatch_n<T, 32>(x, dt, a, b, c, y, bh, t, n, q, stream);
        case 64: return dispatch_n<T, 64>(x, dt, a, b, c, y, bh, t, n, q, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  x is a contiguous (bh, t, p)
// array, b and c (bh, t, n), y (bh, t, p), all of one dtype (0 = float32,
// 1 = bfloat16); dt is (bh, t) float32 after softplus and a is (bh,) float32
// (negative decay rates).  q is the chunk: 1 <= q <= 1024 and t % q == 0.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape or dtype the kernel does not take; an empty problem launches nothing.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a, const void* b,
                              const void* c, void* y, int64_t bh, int64_t t, int64_t p,
                              int64_t n, int64_t q, int dtype, cudaStream_t stream) {
    if (bh == 0 || t == 0) return 0;
    if (bh < 0 || bh > INT_MAX || t < 0 || t > INT_MAX || q < 1 || q > kMaxQ || t % q)
        return (int)cudaErrorInvalidValue;
    const float* dtf = static_cast<const float*>(dt);
    const float* af = static_cast<const float*>(a);
    if (dtype == 0) return dispatch_p<float>(x, dtf, af, b, c, y, bh, t, p, n, q, stream);
    if (dtype == 1)
        return dispatch_p<__nv_bfloat16>(x, dtf, af, b, c, y, bh, t, p, n, q, stream);
    return (int)cudaErrorInvalidValue;
}
