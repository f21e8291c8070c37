// Flash-decoding kernel (K4) of the decode path, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_decode_kernel` (src/repro/kernels/decode_attention.py,
// reached through `decode_attention_bhsd` and `ops.decode_attention`): one
// query row against an S-long KV cache,
//
//     s_j = (q . k_j) * scale  from inputs cast to f32, NEG_INF where valid_j == 0
//     out = sum_j softmax(s)_j v_j, f32 statistics and accumulator, input dtype out.
//
// Design.  The TPU kernel walks the cache blocks of one (b, h) in a
// sequential grid axis, carrying (m, l, acc) in VMEM scratch.  Here the cache
// is cut into splits of `split` keys and the two passes of split-S flash
// decoding run in parallel: pass 1 launches one block per (bh, split); each
// block scores its keys (one warp per key, lanes over hd, a shuffle
// reduction), takes the split's max m and sum l of exp(s - m) over the whole
// block, and writes m, l and acc = sum_j exp(s_j - m) v_j (threads over hd)
// to an f32 workspace.  Pass 2 launches one block per bh and merges the
// splits: M = max m_i, out = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-30).
//
// A masked score is the finite NEG_INF = -2e38, as in the Pallas kernel and
// the oracle.  A split whose keys are all masked has m = NEG_INF, l = its key
// count and acc = the sum of its v rows; merged beside a split with a real
// max it weighs exp(-2e38 - M) = 0.  A row with no valid key at all merges to
// sum(v) / S, the uniform mean of v that the oracle's softmax gives; with
// -inf it would be exp(-inf + inf), a NaN.
//
// Bound on this card: every k and v byte is read once (at deepseek_7b's
// decode shape, BH 128, S 1024, hd 128, bf16: 67 MB, 20 us at 3.35 TB/s)
// against 4 BH S hd = 67 MFLOP: bytes bound it.  Splits of 256 keys give
// BH * S / 256 blocks (512 at that shape, ~4 per SM) so that enough loads
// are in flight; scores and products are plain f32 FMAs.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// Block-wide reduction through `red` (kWarps floats); every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    x = kMax ? warp_max(x) : warp_sum(x);
    __syncthreads();  // red may still be read by a previous reduction
    if (lane == 0) red[warp] = x;
    __syncthreads();
    float r = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
    return r;
}

// Pass 1: one block per (bh, split).  Workspace layout per (bh, split):
// m, l, then hd accumulator floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ valid,
                    float* __restrict__ ws, int s, int hd, int split, float scale) {
    extern __shared__ float smem[];
    float* qs = smem;        // hd
    float* ps = qs + hd;     // split: scores, then probabilities
    float* red = ps + split; // kWarps

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const size_t bh = blockIdx.x;
    const int sp = blockIdx.y, nsplit = gridDim.y;
    const int j0 = sp * split;
    const int n = min(split, s - j0);
    const T* kg = k + (bh * s + j0) * hd;
    const T* vg = v + (bh * s + j0) * hd;
    const int* vd = valid + bh * s + j0;

    for (int d = tid; d < hd; d += kThreads) qs[d] = to_f32(q[bh * hd + d]);
    __syncthreads();

    for (int j = warp; j < n; j += kWarps) {
        const T* row = kg + (size_t)j * hd;
        float acc = 0.f;
        for (int d = lane; d < hd; d += 32) acc = fmaf(qs[d], to_f32(row[d]), acc);
        acc = warp_sum(acc);
        if (lane == 0) ps[j] = vd[j] > 0 ? acc * scale : kNegInf;
    }
    __syncthreads();

    float mx = kNegInf;
    for (int j = tid; j < n; j += kThreads) mx = fmaxf(mx, ps[j]);
    const float m = block_reduce<true>(mx, red);
    float sum = 0.f;
    for (int j = tid; j < n; j += kThreads) {
        const float p = expf(ps[j] - m);
        ps[j] = p;
        sum += p;
    }
    const float l = block_reduce<false>(sum, red);  // its barriers publish ps

    float* out = ws + (bh * nsplit + sp) * (size_t)(hd + 2);
    for (int d = tid; d < hd; d += kThreads) {
        float acc = 0.f;
        for (int j = 0; j < n; ++j) acc = fmaf(ps[j], to_f32(vg[(size_t)j * hd + d]), acc);
        out[2 + d] = acc;
    }
    if (tid == 0) {
        out[0] = m;
        out[1] = l;
    }
}

// Pass 2: one block per bh merges its splits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ o, int hd, int nsplit) {
    const size_t bh = blockIdx.x;
    const float* w = ws + bh * nsplit * (size_t)(hd + 2);
    const size_t stride = hd + 2;
    float m = kNegInf;
    for (int i = 0; i < nsplit; ++i) m = fmaxf(m, w[i * stride]);
    float l = 0.f;
    for (int i = 0; i < nsplit; ++i) l = fmaf(w[i * stride + 1], expf(w[i * stride] - m), l);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    for (int d = threadIdx.x; d < hd; d += kThreads) {
        float acc = 0.f;
        for (int i = 0; i < nsplit; ++i)
            acc = fmaf(w[i * stride + 2 + d], expf(w[i * stride] - m), acc);
        o[bh * hd + d] = from_f32<T>(acc * inv);
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* valid, void* o,
           float* ws, int64_t bh, int64_t s, int64_t hd, int64_t split, float scale,
           cudaStream_t stream) {
    const int nsplit = (int)((s + split - 1) / split);
    const size_t smem = sizeof(float) * (size_t)(hd + split + kWarps);
    decode_split_kernel<T><<<dim3((unsigned)bh, (unsigned)nsplit), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid,
        ws, (int)s, (int)hd, (int)split, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    decode_combine_kernel<T><<<(unsigned)bh, kThreads, 0, stream>>>(
        ws, static_cast<T*>(o), (int)hd, nsplit);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q is a contiguous (bh, 1, hd)
// array, k and v (bh, s, hd), all of one dtype (0 = float32, 1 = bfloat16);
// valid is (bh, s) int32; o is (bh, 1, hd) in the input dtype; ws is an f32
// workspace of bh * ceil(s / split) * (hd + 2) floats.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape or dtype the kernel does not take; an empty problem launches nothing.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* valid, void* o, void* ws, int64_t bh,
                                      int64_t s, int64_t hd, int64_t split, int dtype,
                                      double scale, cudaStream_t stream) {
    if (bh == 0) return 0;
    if (bh < 0 || bh > INT_MAX || s < 1 || s > INT_MAX || hd < 1 || hd > 4096 || split < 1 ||
        split > 4096 || (s + split - 1) / split > 65535)
        return (int)cudaErrorInvalidValue;
    const int* vd = static_cast<const int*>(valid);
    float* w = static_cast<float*>(ws);
    if (dtype == 0)
        return launch<float>(q, k, v, vd, o, w, bh, s, hd, split, (float)scale, stream);
    if (dtype == 1)
        return launch<__nv_bfloat16>(q, k, v, vd, o, w, bh, s, hd, split, (float)scale, stream);
    return (int)cudaErrorInvalidValue;
}
