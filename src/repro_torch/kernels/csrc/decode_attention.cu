// Flash-decoding kernel (K4) of the decode path, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_decode_kernel` (src/repro/kernels/decode_attention.py,
// reached through `decode_attention_bhsd` and `ops.decode_attention`): one
// query row against an S-long KV cache,
//
//     s_j = (q . k_j) * scale  from inputs cast to f32, NEG_INF where valid_j == 0
//     out = sum_j softmax(s)_j v_j, f32 statistics and accumulator, input dtype out.
//
// Bound on this card: the output depends on the k and v rows of the valid
// slots only, so the least traffic is q, the int32 mask, o and those rows
// (at deepseek_7b's decode shape, BH 128, S 1024 with 528 valid, hd 128,
// bf16: 35 MB, 10.5 us at 3.35 TB/s) against 4 BH 528 hd = 35 MFLOP:
// bytes bound it.  Tensor cores buy nothing: one query row per (bh), and the
// interface has already repeated KV heads for GQA.
//
// Two instances behind one wrapper, picked by (dtype, hd) alone.
//
// bf16 at hd 16/32/48/64/128/160/256 (`decode_tiled_kernel<HD>`): the row is
// cut into 64-key tiles; split sp of a row owns tiles sp, sp + nsplit, ...
// (nsplit from ref.decode_split_plan: ~132 blocks, one for each SM), so a
// valid run of any layout spreads evenly over the splits.  A block first
// reads its tiles' valid words (one 64-bit ballot mask a tile) and compacts
// the tiles that hold a valid key; a tile with none issues no load of k or
// v.  Valid tiles stream through a 3-stage ring in shared memory, each tile
// of k and of v one contiguous (rows x hd) range taken by one 1-D bulk copy
// (`cp.async.bulk` completing on an mbarrier); an empty mbarrier per stage
// (one arrival a warp) lets thread 0 refill it.  Scoring: a group of
// hd / 8 lanes (rounded up to a power of two) covers one key with one
// 16-byte shared load a lane and a shuffle reduction, so a warp scores
// 32 / group keys a step; each group keeps its own online softmax (m, l, and
// 8 accumulator dims a lane) in registers over its stripe of keys, and the
// groups merge once at the end of the block.  A masked key in a tile that is
// read is selected out (never multiplied by a zero weight), so non-finite
// values in masked slots reach nothing; unread tiles cannot either.  The
// Pallas kernel reads every slot, and 0 * NaN there propagates: the two
// differ only when masked slots hold non-finite values, which the models'
// zero-initialised caches never do.  A split that read nothing writes
// m = NEG_INF, l = 0, acc = 0 and weighs exactly 0 in the merge.  The merge
// takes no second kernel: each block writes its split's (m, l, acc) to the
// workspace, and the last block of the row to finish (a per-row counter in
// the workspace, zeroed by a memset before the launch) merges the splits in
// split order, so the result does not depend on which block finishes last.  A row
// whose splits all read nothing (no valid slot at all) comes out as
// sum(v) / S, the uniform mean that the oracle's softmax gives, and only
// such a row reads its masked v.
//
// float32, and bf16 at any other hd (`decode_split_kernel<T>`, the first
// design): one block per (bh, 256-key split) scores every key (one warp a
// key, lanes over hd), and `decode_combine_kernel<T>` merges.  A masked
// score is the finite NEG_INF = -2e38; a split whose keys are all masked has
// m = NEG_INF, l = its key count and acc = the sum of its v rows; merged
// beside a split with a real max it weighs exp(-2e38 - M) = 0, and a row
// with no valid key merges to sum(v) / S (with -inf it would be
// exp(-inf + inf), a NaN).  It reads every slot, 67 MB at the shape above.
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


// ---------------------------------------------------------------------------
// The bf16 instance: valid tiles only, through a bulk-copy ring.

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;              // keys of a tile (ref.DECODE_TILE)
constexpr int kStages = 3;             // tiles of k and v in flight a block
constexpr int kMaxSplitTiles = 1024;   // tiles a split may own (ref.DECODE_MAX_SPLIT_TILES)
constexpr int kMaxDevices = 64;

constexpr int pow2_at_least(int x) {
    int p = 1;
    while (p < x) p *= 2;
    return p;
}

template <int HD>
struct TiledPlan {
    static constexpr int kChunks = HD / 8;                   // 16-byte chunks of a row
    static constexpr int kGroup = pow2_at_least(kChunks);    // lanes that score one key
    static constexpr int kKeysPerWarp = 32 / kGroup;
    // 8 warps, or as many as give each key of a tile its own group
    static constexpr int kWarps = kTile / kKeysPerWarp < 8 ? kTile / kKeysPerWarp : 8;
    static constexpr int kThreads = 32 * kWarps;
    static constexpr int kGroups = kWarps * kKeysPerWarp;    // keys a block scores at once
    static constexpr int kKeysPerGroup = kTile / kGroups;    // a group's keys of a tile
    static constexpr int kTileBytes = kTile * HD * 2;        // one tile of k (or v)
    static constexpr int kRingBytes = kStages * 2 * kTileBytes;
    static_assert(HD % 8 == 0 && kGroup <= 32 && kTile % kGroups == 0, "head dim");
    static_assert((2 + HD) * kGroups * 4 <= kRingBytes, "group merge fits in the ring");
    // ring, full and empty mbarriers, a mask word and a list entry per owned
    // tile, the count of valid tiles
    static constexpr size_t smem(int owned) {
        return kRingBytes + 2 * kStages * 8 + (size_t)owned * 12 + 16;
    }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// One contiguous global range into shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(h[i]);
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
    }
}

// One block per (bh, split).  Workspace layout per (bh, split): m, l, then
// HD accumulator floats.  The last block of a row to finish merges the row.
template <int HD>
__global__ void __launch_bounds__(TiledPlan<HD>::kThreads)
decode_tiled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ valid,
                    bf16* __restrict__ o, float* __restrict__ ws, int* __restrict__ counters,
                    int s, int ntiles, float scale) {
    using P = TiledPlan<HD>;
    constexpr int NK = P::kKeysPerGroup;
    extern __shared__ __align__(128) unsigned char tiled_smem[];
    unsigned char* smem = tiled_smem;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const size_t bh = blockIdx.x;
    const int sp = blockIdx.y, nsplit = gridDim.y;
    const int cap = (ntiles + nsplit - 1) / nsplit;  // tiles the first split owns
    const int owned = (ntiles - sp + nsplit - 1) / nsplit;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kRingBytes);
    uint64_t* empty = full + kStages;
    uint64_t* masks = empty + kStages;
    int* list = reinterpret_cast<int*>(masks + cap);
    int* n_live = list + cap;

    if (tid == 0) {
        for (int i = 0; i < kStages; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], P::kWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the valid words of the owned tiles: one 64-bit mask a tile
    const int* vrow = valid + bh * s;
    for (int i = warp; i < owned; i += P::kWarps) {
        const int k0 = (sp + i * nsplit) * kTile;
        const int a = k0 + lane, b = k0 + 32 + lane;
        const unsigned lo = __ballot_sync(0xffffffffu, a < s && vrow[a] > 0);
        const unsigned hi = __ballot_sync(0xffffffffu, b < s && vrow[b] > 0);
        if (lane == 0) masks[i] = (uint64_t)hi << 32 | lo;
    }
    __syncthreads();
    if (warp == 0) {  // compact the tiles that hold a valid key, in order
        int n = 0;
        for (int base = 0; base < owned; base += 32) {
            const int i = base + lane;
            const bool live = i < owned && masks[i] != 0;
            const unsigned bal = __ballot_sync(0xffffffffu, live);
            if (live) list[n + __popc(bal & ((1u << lane) - 1u))] = i;
            n += __popc(bal);
        }
        if (lane == 0) *n_live = n;
    }
    __syncthreads();
    const int nlive = *n_live;

    auto issue = [&](int j) {  // thread 0: live tile j into stage j % kStages
        const int st = j % kStages;
        const int k0 = (sp + list[j] * nsplit) * kTile;
        const unsigned bytes = (unsigned)min(kTile, s - k0) * HD * 2;
        unsigned char* dst = smem + st * 2 * P::kTileBytes;
        const size_t off = (bh * s + k0) * HD;
        mbar_expect_tx(&full[st], 2 * bytes);
        bulk_load(dst, k + off, bytes, &full[st]);
        bulk_load(dst + P::kTileBytes, v + off, bytes, &full[st]);
    };
    if (tid == 0)
        for (int j = 0; j < min(kStages, nlive); ++j) issue(j);

    // lane c of a group owns dims [8c, 8c + 8) of its group's keys; a lane
    // past the row (hd 48, 160) reads chunk 0 against a zero q and owns nothing
    const int c = lane % P::kGroup;
    const int g = warp * P::kKeysPerWarp + lane / P::kGroup;
    const bool has = P::kChunks == P::kGroup || c < P::kChunks;
    const int cc = has ? c : 0;
    float qf[8] = {}, acc[8] = {};
    if (has) unpack8(*reinterpret_cast<const uint4*>(q + bh * HD + c * 8), qf);
    float m = kNegInf, l = 0.f;

    for (int j = 0; j < nlive; ++j) {
        const int st = j % kStages;
        mbar_wait(&full[st], (j / kStages) & 1);
        const uint64_t mask = masks[list[j]];
        const bf16* ks = reinterpret_cast<const bf16*>(smem + st * 2 * P::kTileBytes);
        const bf16* vs = ks + kTile * HD;
        // scores of the group's NK keys of the tile (keys g, g + kGroups, ...)
        float sc[NK];
#pragma unroll
        for (int it = 0; it < NK; ++it) {
            float kf[8];
            unpack8(*reinterpret_cast<const uint4*>(ks + (it * P::kGroups + g) * HD + cc * 8), kf);
            float dot = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) dot = fmaf(qf[i], kf[i], dot);
            sc[it] = dot;
        }
#pragma unroll
        for (int o = P::kGroup / 2; o > 0; o >>= 1) {
#pragma unroll
            for (int it = 0; it < NK; ++it) sc[it] += __shfl_xor_sync(0xffffffffu, sc[it], o);
        }
        // the tile's step of the group's online softmax; a masked key is
        // selected out of the max, the weights and the accumulator
        float mt = m;
#pragma unroll
        for (int it = 0; it < NK; ++it) {
            const bool ok = (mask >> (it * P::kGroups + g)) & 1;
            sc[it] *= scale;
            mt = ok ? fmaxf(mt, sc[it]) : mt;
        }
        const float alpha = expf(m - mt);
        l *= alpha;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] *= alpha;
#pragma unroll
        for (int it = 0; it < NK; ++it) {
            const bool ok = (mask >> (it * P::kGroups + g)) & 1;
            const float p = ok ? expf(sc[it] - mt) : 0.f;
            l += p;
            float vf[8];
            unpack8(*reinterpret_cast<const uint4*>(vs + (it * P::kGroups + g) * HD + cc * 8), vf);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i] = ok ? fmaf(p, vf[i], acc[i]) : acc[i];
        }
        m = mt;
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        if (tid == 0 && j + kStages < nlive) {
            mbar_wait(&empty[st], (j / kStages) & 1);
            issue(j + kStages);
        }
    }

    // merge the groups through the (drained) ring
    __syncthreads();
    float* gm = reinterpret_cast<float*>(smem);
    float* gl = gm + P::kGroups;
    float* gacc = gl + P::kGroups;
    if (c == 0) {
        gm[g] = m;
        gl[g] = l;
    }
    if (has) {
#pragma unroll
        for (int i = 0; i < 8; ++i) gacc[g * HD + c * 8 + i] = acc[i];
    }
    __syncthreads();
    float mx = kNegInf;
    for (int i = 0; i < P::kGroups; ++i) mx = fmaxf(mx, gm[i]);
    const size_t stride = HD + 2;
    float* row = ws + bh * nsplit * stride;
    for (int d = tid; d < HD; d += P::kThreads) {
        float a = 0.f;
        for (int i = 0; i < P::kGroups; ++i) a = fmaf(expf(gm[i] - mx), gacc[i * HD + d], a);
        row[sp * stride + 2 + d] = a;
    }
    if (tid == 0) {
        float sum = 0.f;
        for (int i = 0; i < P::kGroups; ++i) sum = fmaf(expf(gm[i] - mx), gl[i], sum);
        row[sp * stride] = mx;
        row[sp * stride + 1] = sum;
    }

    // the last split of the row to finish merges the row's splits in split order
    int* last = n_live + 1;
    if (nsplit > 1) {
        __threadfence();  // publish this split's (m, l, acc)
        __syncthreads();
        if (tid == 0) *last = atomicAdd(&counters[bh], 1) == nsplit - 1;
        __syncthreads();
        if (!*last) return;
        __threadfence();  // and see the others'
    }
    __syncthreads();
    float* w_s = reinterpret_cast<float*>(smem);  // per-split weights, kThreads at a time
    float* l_s = w_s + P::kThreads;
    float* red = l_s + P::kThreads;               // kWarps
    float big = kNegInf;
    for (int i = tid; i < nsplit; i += P::kThreads) big = fmaxf(big, __ldcg(row + i * stride));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, off));
    if (lane == 0) red[warp] = big;
    __syncthreads();
    big = red[0];
    for (int i = 1; i < P::kWarps; ++i) big = fmaxf(big, red[i]);
    constexpr int kDims = (HD + P::kThreads - 1) / P::kThreads;  // dims a thread owns
    float a[kDims] = {};
    float sum = 0.f;
    for (int base = 0; base < nsplit; base += P::kThreads) {
        __syncthreads();
        const int i = base + tid;
        if (i < nsplit) {
            const float w = expf(__ldcg(row + i * stride) - big);
            w_s[tid] = w;
            l_s[tid] = w * __ldcg(row + i * stride + 1);
        }
        __syncthreads();
        const int n = min(P::kThreads, nsplit - base);
#pragma unroll 4
        for (int t = 0; t < n; ++t) {
            sum += l_s[t];
#pragma unroll
            for (int dd = 0; dd < kDims; ++dd) {
                const int d = tid + dd * P::kThreads;
                if (d < HD) a[dd] = fmaf(w_s[t], __ldcg(row + (base + t) * stride + 2 + d), a[dd]);
            }
        }
    }
    if (sum > 0.f) {
        const float inv = 1.f / sum;
#pragma unroll
        for (int dd = 0; dd < kDims; ++dd) {
            const int d = tid + dd * P::kThreads;
            if (d < HD) o[bh * HD + d] = __float2bfloat16_rn(a[dd] * inv);
        }
    } else {  // no valid slot in the row: the mean of v over all s slots
        const bf16* vr = v + bh * s * (size_t)HD;
#pragma unroll
        for (int dd = 0; dd < kDims; ++dd) {
            const int d = tid + dd * P::kThreads;
            if (d >= HD) continue;
            float t = 0.f;
            for (int j = 0; j < s; ++j) t += __bfloat162float(vr[(size_t)j * HD + d]);
            o[bh * HD + d] = __float2bfloat16_rn(t / (float)s);
        }
    }
}

template <int HD>
int launch_tiled(const void* q, const void* k, const void* v, const int* valid, void* o,
                 float* ws, int* counters, int64_t bh, int64_t s, int64_t nsplit, float scale,
                 cudaStream_t stream) {
    using P = TiledPlan<HD>;
    static bool configured[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!configured[dev]) {
        err = cudaFuncSetAttribute((const void*)decode_tiled_kernel<HD>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)P::smem(kMaxSplitTiles));
        if (err != cudaSuccess) return (int)err;
        configured[dev] = true;
    }
    const int ntiles = (int)((s + kTile - 1) / kTile);
    const int cap = (int)((ntiles + nsplit - 1) / nsplit);
    decode_tiled_kernel<HD><<<dim3((unsigned)bh, (unsigned)nsplit), P::kThreads, P::smem(cap),
                              stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        valid, static_cast<bf16*>(o), ws, counters, (int)s, ntiles, scale);
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

// Plain C entry point of the bf16 instance, loaded with ctypes.  q is a
// contiguous (bh, 1, hd) bf16 array, k and v (bh, s, hd), valid (bh, s)
// int32, o (bh, 1, hd) bf16, all 16-byte aligned; hd one of 16, 32, 48,
// 64, 128, 160, 256; nsplit in [1, ceil(s / 64)] with at most 1024 tiles a
// split (ref.decode_split_plan); ws a workspace of bh * nsplit * (hd + 2)
// floats, then bh int32 "splits done" counters, which are zeroed here when
// nsplit > 1.  Returns the first CUDA error of the (memset and) launch, or
// cudaErrorInvalidValue for a shape or alignment the kernel does not take;
// an empty problem launches nothing.
extern "C" int repro_decode_attention_tiled(const void* q, const void* k, const void* v,
                                            const void* valid, void* o, void* ws, int64_t bh,
                                            int64_t s, int64_t hd, int64_t nsplit,
                                            double scale, cudaStream_t stream) {
    if (bh == 0) return 0;
    const int64_t ntiles = (s + kTile - 1) / kTile;
    if (bh < 0 || bh > INT_MAX || s < 1 || s > INT_MAX / 2 || nsplit < 1 || nsplit > ntiles ||
        nsplit > 65535 || (ntiles + nsplit - 1) / nsplit > kMaxSplitTiles)
        return (int)cudaErrorInvalidValue;
    const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
    if (any % 16) return (int)cudaErrorInvalidValue;
    const int* vd = static_cast<const int*>(valid);
    float* w = static_cast<float*>(ws);
    int* cnt = reinterpret_cast<int*>(w + bh * nsplit * (hd + 2));
    if (nsplit > 1) {
        const cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * bh, stream);
        if (err != cudaSuccess) return (int)err;
    }
    const float sc = (float)scale;
#define REPRO_DECODE_HD(HD) \
    case HD:                \
        return launch_tiled<HD>(q, k, v, vd, o, w, cnt, bh, s, nsplit, sc, stream);
    switch (hd) {
        REPRO_DECODE_HD(16)
        REPRO_DECODE_HD(32)
        REPRO_DECODE_HD(48)
        REPRO_DECODE_HD(64)
        REPRO_DECODE_HD(128)
        REPRO_DECODE_HD(160)
        REPRO_DECODE_HD(256)
        default: return (int)cudaErrorInvalidValue;
    }
#undef REPRO_DECODE_HD
}
