// Flash-attention forward kernel (K3) of the model path, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_kernel` (src/repro/kernels/flash_attention.py,
// reached through `flash_attention_bhtd` and `ops.flash_attention`): causal
// attention over (BH, T, hd) with an optional sliding window,
//
//     keep(q, k) = q >= k && (q - k) < window
//     s = (q . k) * scale  from inputs cast to f32, NEG_INF where not kept
//     online softmax with f32 running max m, sum l and accumulator acc
//     out = acc / max(l, 1e-30), in the input dtype.
//
// Design.  One thread block per (bh, 64-row query tile); a loop inside the
// block walks the 32-key KV tiles in ascending order, where the TPU kernel had
// a sequential grid axis with scratch carried between grid steps.  The loop
// bounds are the live tiles only: up to the causal diagonal, and from the
// first tile that overlaps the window, so a fully masked tile is never loaded
// (the Pallas kernel's `live` test at :59-65, on this kernel's finer tiles).
// Q, K and V tiles are staged in shared memory as f32, rows padded by one word
// so that the 16 lanes reading 16 rows at one column hit 16 banks.  256 threads
// as 16 x 16: each thread keeps a 4 x 2 block of scores and a 4 x hd/16 block
// of the output accumulator in registers; 4 threads share a row for the
// softmax statistics.  Products are plain f32 FMAs, for bf16 and f32 alike,
// so f32 inputs are not rounded to TF32.
//
// A masked score is the finite NEG_INF = -2e38, as in the Pallas kernel: a row
// whose first live tile is entirely outside its window briefly accumulates
// p = exp(0) = 1 and the next tile with a kept key wipes it with
// alpha = exp(NEG_INF - m) = 0.  With -inf that step would be exp(-inf + inf),
// a NaN.  Every row keeps at least its own key (window >= 1).
//
// Bound on this card: at serving prefill (BH 128, T 512, hd 128, bf16) the
// causal half of 4 BH T^2 hd flops is 8.6 GFLOP, 8.7 us at the bf16 tensor
// rate, while q, k, v and o are 67 MB, 20 us at 3.35 TB/s: bytes bound it.
// This kernel does its products on the f32 FMA units from shared memory and
// is far from either; tensor-core (mma/wgmma) tiles and TMA loads are the
// later work that closes the gap.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kSld = kBK + 1;  // padded row of the score tile
constexpr float kNegInf = -2.0e38f;

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

template <int HD>
constexpr size_t smem_bytes() {
    // q tile, k tile, v tile (rows padded to HD + 1), score tile, m/l/alpha
    return sizeof(float) *
           (size_t)(kBQ * (HD + 1) + 2 * kBK * (HD + 1) + kBQ * kSld + 3 * kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int t,
                       float scale, int window) {
    constexpr int LD = HD + 1;
    constexpr int RJ = HD / 16;  // output columns a thread owns
    extern __shared__ float smem[];
    float* qs = smem;             // kBQ x LD
    float* ks = qs + kBQ * LD;    // kBK x LD
    float* vs = ks + kBK * LD;    // kBK x LD
    float* ps = vs + kBK * LD;    // kBQ x kSld: scores, then probabilities
    float* m_s = ps + kBQ * kSld; // running max per row
    float* l_s = m_s + kBQ;       // running sum per row
    float* a_s = l_s + kBQ;       // this tile's rescale factor per row

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    // the last query tiles have the most live KV tiles: schedule them first
    const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
    const size_t base = (size_t)blockIdx.x * t * HD;
    const T* qg = q + base;
    const T* kg = k + base;
    const T* vg = v + base;

    for (int e = tid; e < kBQ * HD; e += kThreads) {
        const int r = e / HD, c = e % HD;
        qs[r * LD + c] = (q0 + r < t) ? to_f32(qg[(size_t)(q0 + r) * HD + c]) : 0.f;
    }
    if (tid < kBQ) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }
    float acc[4][RJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) acc[i][j] = 0.f;

    // Live KV tiles: causal upper bound; the window's lower bound is the first
    // tile whose last key k satisfies q0 - k < window.
    const int q_last = min(q0 + kBQ, t) - 1;
    const int kt_hi = q_last / kBK;
    const long long first = (long long)q0 - window - kBK + 2;
    const int kt_lo = first <= 0 ? 0 : (int)((first + kBK - 1) / kBK);

    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int k0 = kt * kBK;
        __syncthreads();  // the previous tile's readers of ks, vs, ps are done
        for (int e = tid; e < kBK * HD; e += kThreads) {
            const int r = e / HD, c = e % HD;
            const bool in = k0 + r < t;
            const size_t g = (size_t)(k0 + r) * HD + c;
            ks[r * LD + c] = in ? to_f32(kg[g]) : 0.f;
            vs[r * LD + c] = in ? to_f32(vg[g]) : 0.f;
        }
        __syncthreads();

        // scores of rows ty + 16 i against keys tx + 16 j
        float s[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            float qv[4], kv[2];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
            for (int j = 0; j < 2; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int qp = q0 + ty + 16 * i, kp = k0 + tx + 16 * j;
                const bool keep = qp >= kp && (qp - kp) < window;
                ps[(ty + 16 * i) * kSld + tx + 16 * j] = keep ? s[i][j] * scale : kNegInf;
            }
        __syncthreads();

        // online softmax: four neighbouring lanes share a row, 8 keys each
        {
            const int r = tid / 4, part = tid % 4;
            float* row = ps + r * kSld + part * 8;
            float mx = row[0];
#pragma unroll
            for (int c = 1; c < 8; ++c) mx = fmaxf(mx, row[c]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_prev = m_s[r];
            const float m_new = fmaxf(m_prev, mx);
            float sum = 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const float p = expf(row[c] - m_new);
                row[c] = p;
                sum += p;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (part == 0) {
                const float alpha = expf(m_prev - m_new);
                a_s[r] = alpha;
                l_s[r] = l_s[r] * alpha + sum;
                m_s[r] = m_new;
            }
        }
        __syncthreads();

        // acc = acc * alpha + P V
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float alpha = a_s[ty + 16 * i];
#pragma unroll
            for (int j = 0; j < RJ; ++j) acc[i][j] *= alpha;
        }
#pragma unroll 4
        for (int kk = 0; kk < kBK; ++kk) {
            float pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kSld + kk];
#pragma unroll
            for (int j = 0; j < RJ; ++j) {
                const float vv = vs[kk * LD + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
            }
        }
    }
    __syncthreads();

    T* og = o + base;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (q0 + r >= t) continue;
        const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < RJ; ++j)
            og[(size_t)(q0 + r) * HD + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t bh,
           int64_t t, float scale, int window, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<HD>();
    // The shared-memory attributes belong to each device's context: set them
    // once per device, on its first launch (before any graph capture).
    constexpr int kMaxDevices = 64;
    static bool configured[kMaxDevices] = {};
    int dev = 0;
    cudaError_t dev_err = cudaGetDevice(&dev);
    if (dev_err != cudaSuccess) return (int)dev_err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!configured[dev]) {
        cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       (int)cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return (int)err;
        configured[dev] = true;
    }
    const dim3 grid((unsigned)bh, (unsigned)((t + kBQ - 1) / kBQ));
    flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), (int)t, scale, window);
    return (int)cudaGetLastError();
}

// Any multiple of 16 can be an instance (hd / 16 output columns a thread);
// these are the head dims the configs use.  At hd 256 a thread keeps 64
// accumulator floats and the tiles take 141 KB of shared memory.
template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int64_t bh,
                int64_t t, int64_t hd, float scale, int window, cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, o, bh, t, scale, window, stream);
        case 32: return launch<T, 32>(q, k, v, o, bh, t, scale, window, stream);
        case 48: return launch<T, 48>(q, k, v, o, bh, t, scale, window, stream);
        case 64: return launch<T, 64>(q, k, v, o, bh, t, scale, window, stream);
        case 128: return launch<T, 128>(q, k, v, o, bh, t, scale, window, stream);
        case 160: return launch<T, 160>(q, k, v, o, bh, t, scale, window, stream);
        case 256: return launch<T, 256>(q, k, v, o, bh, t, scale, window, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, k, v and o are contiguous
// (bh, t, hd) arrays of one dtype: 0 = float32, 1 = bfloat16.  `window` is
// the sliding window in positions (>= 1; larger than t means none).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// or dtype the kernel does not take; an empty problem launches nothing.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int64_t bh, int64_t t, int64_t hd,
                                     int dtype, double scale, int64_t window,
                                     cudaStream_t stream) {
    if (bh == 0 || t == 0) return 0;
    if (bh < 0 || bh > INT_MAX || t < 0 || t > INT_MAX || window < 1 ||
        (t + kBQ - 1) / kBQ > 65535)
        return (int)cudaErrorInvalidValue;
    const int w = window > INT_MAX ? INT_MAX : (int)window;
    if (dtype == 0)
        return dispatch_hd<float>(q, k, v, o, bh, t, hd, (float)scale, w, stream);
    if (dtype == 1)
        return dispatch_hd<__nv_bfloat16>(q, k, v, o, bh, t, hd, (float)scale, w, stream);
    return (int)cudaErrorInvalidValue;
}
