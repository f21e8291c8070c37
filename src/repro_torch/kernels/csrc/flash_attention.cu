// Flash-attention forward kernel (K3) of the model path, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_kernel` (src/repro/kernels/flash_attention.py,
// reached through `flash_attention_bhtd` and `ops.flash_attention`): causal
// attention over (BH, T, hd) with an optional sliding window,
//
//     keep(q, k) = q >= k && (q - k) < window
//     s = (q . k) * scale  accumulated in f32, NEG_INF where not kept
//     online softmax with f32 running max m, sum l and accumulator acc
//     out = acc / max(l, 1e-30), in the input dtype.
//
// Two instances share the entry point and the tile walk: one thread block
// per (bh, 64-row query tile), the heaviest query tiles scheduled first; a
// loop inside the block walks the KV tiles in ascending order, where the TPU
// kernel had a sequential grid axis with scratch carried between grid steps.
// The loop bounds are the live tiles only: up to the causal diagonal, and
// from the first tile that overlaps the window, so a fully masked tile is
// never loaded (the Pallas kernel's `live` test at :59-65, on finer tiles).
//
// bf16: tensor cores (flash_attention_mma_kernel).  4 warps, 16 query rows
// each.  K and V tiles of BK keys (MmaTiles: 64 up to hd 64, 32 above, for
// registers) stream through a 2-stage ring of shared memory by 16-byte
// `cp.async.cg` copies, rows past t zero-filled (src-size 0), one wait and
// one barrier a tile; the copy of tile i + 1 runs under the products of
// tile i.  Shared rows are padded by 8 bf16, so the row stride is an odd
// multiple of 16 bytes at every supported hd and the 8 rows an `ldmatrix`
// phase reads fall in 8 distinct 16-byte bank groups.  S = Q K^T and
// O += P V are `mma.sync.m16n8k16` bf16 products with f32 accumulators;
// Q's fragments stay in registers where MmaTiles says so and are re-read
// from shared memory otherwise.  The softmax runs on the accumulators in
// registers (4 lanes share a row), with the mask applied only on tiles
// that cross the diagonal or the window's edge; a tile where none of a
// warp's rows keeps a key is skipped by that warp, which changes nothing
// (p = 0, alpha = 1; or, before a row's first kept key, a state the next
// tile scales by alpha = 0).  P enters the PV product as two bf16 terms,
// hi = P rounded and lo = P - hi rounded, each used in place as an A
// operand (the m16n8 accumulator layout is the m16n8k16 A layout).  A lone
// bf16 P (2^-9 relative) is off by more than 2e-3 + 2e-2 |out| where a
// short window's few weights cancel; hi + lo keeps ~16 bits of P for one
// more PV product.  The epilogue stages O through shared memory and stores
// 16 bytes a lane.  exp is exp2 on scores pre-scaled by log2(e).
//
// f32: the SIMT kernel (flash_attention_kernel), so f32 inputs are not
// rounded to TF32.  256 threads as 16 x 16 over 32-key tiles staged as f32
// in shared memory, rows padded by one word; each thread keeps a 4 x 2 block
// of scores and a 4 x hd/16 block of the accumulator; plain f32 FMAs.
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
// The bf16 instance keeps S and P in registers, reads q once and k and v
// once per query tile (mostly from L2); the f32 instance is bound by its
// FMAs (the same flops at 67 TFLOP/s take 0.13 ms).
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;  // query rows per block, both instances
constexpr float kNegInf = -2.0e38f;

// ---------------------------------------------------------------------------
// f32 instance: SIMT FMAs
// ---------------------------------------------------------------------------
constexpr int kBK = 32;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kSld = kBK + 1;  // padded row of the score tile

template <int HD>
constexpr size_t smem_bytes() {
    // q tile, k tile, v tile (rows padded to HD + 1), score tile, m/l/alpha
    return sizeof(float) *
           (size_t)(kBQ * (HD + 1) + 2 * kBK * (HD + 1) + kBQ * kSld + 3 * kBQ);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int t,
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
    const float* qg = q + base;
    const float* kg = k + base;
    const float* vg = v + base;

    for (int e = tid; e < kBQ * HD; e += kThreads) {
        const int r = e / HD, c = e % HD;
        qs[r * LD + c] = (q0 + r < t) ? qg[(size_t)(q0 + r) * HD + c] : 0.f;
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
            ks[r * LD + c] = in ? kg[g] : 0.f;
            vs[r * LD + c] = in ? vg[g] : 0.f;
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

    float* og = o + base;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (q0 + r >= t) continue;
        const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < RJ; ++j)
            og[(size_t)(q0 + r) * HD + tx + 16 * j] = acc[i][j] / l;
    }
}

// ---------------------------------------------------------------------------
// bf16 instance: mma.sync tiles fed by cp.async
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows
constexpr int kStages = 2;        // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// The tile plan per head dim (measured on one H100 at the serving shapes):
// 64-key tiles with Q's fragments in registers only up to hd 64; above, 32
// keys and Q re-read from shared memory keep the instance at <= 168
// registers up to hd 128, so 3 blocks share an SM.
template <int HD>
struct MmaTiles {
    static constexpr int BK = HD <= 64 ? 64 : 32;  // keys per KV tile
    static constexpr int LD = HD + 8;              // padded shared row, bf16
    static constexpr int CHUNKS = HD / 8;          // 16-byte chunks a row
    static constexpr bool Q_IN_REGS = HD <= 64;
    static constexpr int MIN_BLOCKS = HD <= 128 ? 3 : 1;  // per SM, for __launch_bounds__
    static constexpr size_t SMEM = sizeof(bf16) * (size_t)(kBQ * LD + 2 * kStages * BK * LD);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x and y as two bf16 pairs, the first value in the low half (the lower
// column): hi = (x, y) rounded, lo = what hi misses, rounded; hi + lo keeps
// ~16 significant bits of each
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const __nv_bfloat162 r = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&r);
}

// rows [row0, row0 + ROWS) of a (t, HD) array into a padded shared tile;
// rows at or past t read nothing and land as zeros
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int t) {
    constexpr int CH = MmaTiles<HD>::CHUNKS, LD = MmaTiles<HD>::LD;
    static_assert(ROWS * CH % kMmaThreads == 0, "a tile is whole 16-byte chunks a thread");
#pragma unroll
    for (int i = 0; i < ROWS * CH / kMmaThreads; ++i) {
        const int c = threadIdx.x + i * kMmaThreads;
        const int r = c / CH, col = (c % CH) * 8;
        const bool in = row0 + r < t;
        cp_async_16(smem_addr(dst + r * LD + col), src + (size_t)(in ? row0 + r : 0) * HD + col,
                    in ? 16 : 0);
    }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, MmaTiles<HD>::MIN_BLOCKS)
flash_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o, int t,
                           float scale_log2, int window) {
    using P = MmaTiles<HD>;
    constexpr int BK = P::BK, LD = P::LD, CH = P::CHUNKS;
    constexpr int KD = HD / 16;  // k-steps of Q K^T
    constexpr int NS = BK / 8;   // 8-key column tiles of S
    constexpr int ND = HD / 8;   // 8-wide column tiles of O
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kBQ x LD
    bf16* ks = qs + kBQ * LD;                       // kStages x BK x LD
    bf16* vs = ks + kStages * BK * LD;              // kStages x BK x LD

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, tq = lane % 4;  // accumulator row and column pair
    // the last query tiles have the most live KV tiles: schedule them first
    const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
    const int qw0 = q0 + 16 * warp;  // this warp's first query row
    const size_t base = (size_t)blockIdx.x * t * HD;
    const bf16* qg = q + base;
    const bf16* kg = k + base;
    const bf16* vg = v + base;

    // Live KV tiles: causal upper bound; the window's lower bound is the first
    // tile whose last key k satisfies q0 - k < window.
    const int q_last = min(q0 + kBQ, t) - 1;
    const int kt_hi = q_last / BK;
    const long long first = (long long)q0 - window - BK + 2;
    const int kt_lo = first <= 0 ? 0 : (int)((first + BK - 1) / BK);

    load_tile<HD, kBQ>(qs, qg, q0, t);
    load_tile<HD, BK>(ks, kg, kt_lo * BK, t);
    load_tile<HD, BK>(vs, vg, kt_lo * BK, t);
    cp_async_commit();

    // ldmatrix row addresses: lane l serves matrix l / 8, row l % 8
    const int a_row = lane % 8 + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);  // Q (A)
    const int b_row = lane % 8 + 8 * (lane / 16), b_col = 8 * ((lane / 8) % 2);  // K (B)
    const int v_row = a_row, v_col = a_col;                                      // V (B, .trans)
    const bf16* q_frag = qs + (16 * warp + a_row) * LD + a_col;

    uint32_t qf[P::Q_IN_REGS ? KD : 1][4];
    float m[2] = {kNegInf, kNegInf};  // running max of rows g and g + 8, log2 units
    float l[2] = {0.f, 0.f};          // this lane's share of the running sums
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int stage = (kt - kt_lo) % kStages;
        cp_async_wait_all();
        // tile kt has landed for every thread, and every warp is done with the
        // stage that the next copy overwrites
        __syncthreads();
        if (kt < kt_hi) {
            const int next = (stage + 1) % kStages;
            load_tile<HD, BK>(ks + next * BK * LD, kg, (kt + 1) * BK, t);
            load_tile<HD, BK>(vs + next * BK * LD, vg, (kt + 1) * BK, t);
        }
        cp_async_commit();
        if constexpr (P::Q_IN_REGS) {
            if (kt == kt_lo) {
#pragma unroll
                for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], smem_addr(q_frag + 16 * kk));
            }
        }
        const int k0 = kt * BK;
        // none of this warp's rows keeps a key of this tile (rows past t, keys
        // past the diagonal, or keys before the window): skip the tile
        if (qw0 >= t || k0 > qw0 + 15 || qw0 - (k0 + BK - 1) >= window) continue;

        // S = Q K^T for rows qw0 + g (+ 8), keys k0 + 8 j + 2 tq (+ 1)
        const bf16* kst = ks + stage * BK * LD;
        float s[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            uint32_t a[4];
            if constexpr (P::Q_IN_REGS) {
                a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
            } else {
                ldmatrix_x4(a, smem_addr(q_frag + 16 * kk));
            }
#pragma unroll
            for (int j = 0; j < NS / 2; ++j) {
                uint32_t b[4];
                ldmatrix_x4(b, smem_addr(kst + (16 * j + b_row) * LD + 16 * kk + b_col));
                mma_bf16(s[2 * j], a, b[0], b[1]);
                mma_bf16(s[2 * j + 1], a, b[2], b[3]);
            }
        }

        // online softmax on the accumulators; the mask only where the tile
        // crosses the diagonal or the window's edge for this warp's rows
        const bool edge = k0 + BK - 1 > qw0 || qw0 + 15 - k0 >= window;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[j][e] * scale_log2;
                if (edge) {
                    const int qp = qw0 + g + 8 * (e / 2), kp = k0 + 8 * j + 2 * tq + e % 2;
                    if (!(qp >= kp && qp - kp < window)) x = kNegInf;
                }
                s[j][e] = x;
                mx[e / 2] = fmaxf(mx[e / 2], x);
            }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            alpha[r] = exp2f(m[r] - mx[r]);
            m[r] = mx[r];
            l[r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = exp2f(s[j][e] - m[e / 2]);
                s[j][e] = p;
                l[e / 2] += p;
            }
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            acc[n][0] *= alpha[0], acc[n][1] *= alpha[0];
            acc[n][2] *= alpha[1], acc[n][3] *= alpha[1];
        }

        // O += P V with P as bf16 hi + lo, each used in place as the A operand
        // of its own product: the m16n8 accumulator layout is the m16n8k16 A
        // layout
        const bf16* vst = vs + stage * BK * LD;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t hi[4], lo[4];
            split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
            split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
            split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
            split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
            for (int dn = 0; dn < HD / 16; ++dn) {
                uint32_t b[4];
                ldmatrix_x4_trans(b, smem_addr(vst + (16 * kk + v_row) * LD + 16 * dn + v_col));
                mma_bf16(acc[2 * dn], hi, b[0], b[1]);
                mma_bf16(acc[2 * dn + 1], hi, b[2], b[3]);
                mma_bf16(acc[2 * dn], lo, b[0], b[1]);
                mma_bf16(acc[2 * dn + 1], lo, b[2], b[3]);
            }
        }
    }

    // epilogue: the warp's 16 rows of O, divided by l, through its own rows of
    // the Q tile (no other warp reads them), then 16 bytes a lane
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = fmaxf(l[r], 1e-30f);
    }
    if (qw0 >= t) return;
    __syncwarp();
    bf16* os = qs + 16 * warp * LD;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<__nv_bfloat162*>(os + (g + 8 * h) * LD + 8 * n + 2 * tq) =
                __floats2bfloat162_rn(acc[n][2 * h] / l[h], acc[n][2 * h + 1] / l[h]);
    __syncwarp();
    bf16* og = o + base;
    static_assert(16 * CH % 32 == 0, "16 rows are whole chunks a lane");
#pragma unroll
    for (int i = 0; i < 16 * CH / 32; ++i) {
        const int c = lane + 32 * i;
        const int r = c / CH, col = (c % CH) * 8;
        if (qw0 + r < t)
            *reinterpret_cast<uint4*>(og + (size_t)(qw0 + r) * HD + col) =
                *reinterpret_cast<const uint4*>(os + r * LD + col);
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
constexpr int kMaxDevices = 64;

// The shared-memory attributes belong to each device's context: set them
// once per device, on its first launch (before any graph capture).
int configure_once(const void* kernel, size_t smem, bool (&configured)[kMaxDevices]) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (configured[dev]) return 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
    return 0;
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o, int64_t bh, int64_t t,
                float scale, int window, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<HD>();
    static bool configured[kMaxDevices] = {};
    const int rc = configure_once((const void*)flash_attention_kernel<HD>, smem, configured);
    if (rc != 0) return rc;
    const dim3 grid((unsigned)bh, (unsigned)((t + kBQ - 1) / kBQ));
    flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), (int)t, scale, window);
    return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int64_t bh, int64_t t,
               float scale, int window, cudaStream_t stream) {
    constexpr size_t smem = MmaTiles<HD>::SMEM;
    static bool configured[kMaxDevices] = {};
    const int rc = configure_once((const void*)flash_attention_mma_kernel<HD>, smem, configured);
    if (rc != 0) return rc;
    const dim3 grid((unsigned)bh, (unsigned)((t + kBQ - 1) / kBQ));
    flash_attention_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), (int)t, scale * kLog2e, window);
    return (int)cudaGetLastError();
}

// Every head dim a config uses.  The SIMT instance takes any multiple of 16
// (hd / 16 output columns a thread; at hd 256 its tiles take 141 KB of shared
// memory); the tensor-core instance any multiple of 16 whose padded row
// stays an odd multiple of 16 bytes (at hd 256: 99 KB, 128 accumulators).
template <bool MMA>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int64_t bh, int64_t t,
                int64_t hd, float scale, int window, cudaStream_t stream) {
#define REPRO_FLASH_HD(HD)                                                         \
    case HD:                                                                       \
        return MMA ? launch_mma<HD>(q, k, v, o, bh, t, scale, window, stream)      \
                   : launch_simt<HD>(q, k, v, o, bh, t, scale, window, stream);
    switch (hd) {
        REPRO_FLASH_HD(16)
        REPRO_FLASH_HD(32)
        REPRO_FLASH_HD(48)
        REPRO_FLASH_HD(64)
        REPRO_FLASH_HD(128)
        REPRO_FLASH_HD(160)
        REPRO_FLASH_HD(256)
        default: return (int)cudaErrorInvalidValue;
    }
#undef REPRO_FLASH_HD
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, k, v and o are contiguous
// (bh, t, hd) arrays of one dtype: 0 = float32 (the SIMT instance), 1 =
// bfloat16 (the tensor-core instance, which needs 16-byte aligned arrays, as
// every allocation is).  `window` is the sliding window in positions (>= 1;
// larger than t means none).  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a shape, dtype or alignment the kernel does
// not take; an empty problem launches nothing.
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
        return dispatch_hd<false>(q, k, v, o, bh, t, hd, (float)scale, w, stream);
    if (dtype == 1) {
        const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
        if (any % 16) return (int)cudaErrorInvalidValue;
        return dispatch_hd<true>(q, k, v, o, bh, t, hd, (float)scale, w, stream);
    }
    return (int)cudaErrorInvalidValue;
}
