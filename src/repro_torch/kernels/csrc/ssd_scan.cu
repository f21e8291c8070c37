// Mamba2 SSD chunked-scan kernel (K5), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_ssd_kernel` (src/repro/kernels/ssd_scan.py,
// reached through `ssd_scan_bhtpn` and `ops.ssd_scan`).  Per (b, h) row and
// per chunk of Q steps, with x (Q, P), dt (Q), the head's decay rate A,
// B and C (Q, N) and the (P, N) f32 state S entering the chunk:
//
//     a_cum = cumsum(dt * A)
//     L[i, j] = exp(a_cum[i] - a_cum[j]) for j <= i, else 0
//     y = ((C B^T) o L o dt^T) x + exp(a_cum) o (C S^T)
//     S' = exp(a_cum[Q-1]) S + (w o x)^T B,  w = dt o exp(a_cum[Q-1] - a_cum)
//
// all accumulated in f32 from inputs cast once; y in the input dtype.
//
// Design.  The TPU kernel carries S in VMEM scratch across a sequential grid
// axis over chunks.  Blocks here run in no order, so that axis becomes three
// passes, launched back to back on the caller's stream:
//
//   1. chunk states, one block per (row, chunk): a_cum by a block-wide prefix
//      sum (per-thread runs, a warp scan, a scan of the warp totals), written
//      to the workspace, and dS = (w o x)^T B, the (P, N) state the chunk
//      would leave from a zero start;
//   2. state passing, one thread per (row, state entry): S_0 = 0,
//      S_{c+1} = exp(a_cum_c[Q-1]) S_c + dS_c, T/Q elementwise steps; each
//      dS_c is overwritten in place by the S_c that enters chunk c;
//   3. chunk scan, one block per (row, chunk, 64-row query tile), the
//      heaviest tiles (most key tiles) first: the state term
//      exp(a_cum_i) (C_i S_c^T), then for each key tile j <= i
//      y_i += G_ij x_j with G_ij = (C_i B_j^T) o L_ij o dt_j.
//
// Pass 3 is K3's structure with Q -> C, K -> B, V -> x and the decayed
// scores in place of softmax's P, with no running max.
//
// bf16: tensor cores (passes 1 and 3 are *_mma).  4 warps; `mma.sync`
// m16n8k16 bf16 products with f32 accumulators; B_j and x_j tiles stream
// through a 2-stage ring of shared memory by 16-byte `cp.async.cg` copies,
// rows past the chunk zero-filled (src-size 0); shared rows padded by 8 bf16,
// an odd multiple of 16 bytes at every supported P and N, so `ldmatrix`
// phases are free of bank conflicts.  Every product has one exact bf16
// operand (x, B or C); its other operand is f32 (w o x, S_c or G) and enters
// as hi = bf16(v) and lo = bf16(v - hi), two products, ~2^-16 relative, as
// K3 feeds P.  Pass 1 puts w on x, not on B: the A fragment of (w o x)^T is
// split once per k-step and reused across the warp's n-blocks.  N = 8 runs
// as N = 16 with zero columns, so C B^T keeps its k16 depth.  In pass 3 each
// warp owns 16 query rows; its S_c fragments come straight from the
// workspace (L2) into registers, split there.
//
// f32: SIMT FMA tiles on the same grid (passes 1 and 3 are *_simt), so f32
// inputs are never rounded.  Pass 3 stages C_i, B_j and dt o x_j as f32 in
// shared memory; 256 threads as 16 x 16 own 4 rows x P/16 columns of y.
//
// Bound on this card: at mamba2_130m's full-width prefill (BH 96, T 512,
// P 64, N 128, chunk 256, bf16) x, B, C and y are 38 MB, 11 us at 3.35 TB/s,
// and the chunked algebra is ~4 GFLOP, 4 us at the bf16 tensor rate: bytes
// bound it.  The passes add a workspace of (BH, T/Q, P, N) f32 states
// (6.3 MB at that shape, written by pass 1, rewritten in place by pass 2,
// read by pass 3, mostly from the 50 MB L2) and (BH, T) f32 cumulative
// decays; the hi + lo terms double the tensor-core work, which is far below
// its bound.  Pass 1 runs BH * T/Q blocks (192 at that shape) and pass 3
// BH * T/Q * ceil(Q/64) (768), where a block per row gave 96.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;        // rows of a query or key tile
constexpr int kMaxQ = 1024;   // longest chunk
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------
// Inclusive prefix sum of dt[i] * A over i < q into out; ends with a barrier.
template <int THREADS>
__device__ void chunk_cumsum(const float* __restrict__ dt, float A, int q, float* out,
                             float* red) {
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int per = (q + THREADS - 1) / THREADS;
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

// The shared-memory attribute belongs to each device's context: set it once
// per device, on its first launch.
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

// ---------------------------------------------------------------------------
// pass 2: state passing (both dtypes)
// ---------------------------------------------------------------------------
constexpr int kPassThreads = 256;

// ws_state is (bh, nc, pn): dS_c in, the state entering chunk c out.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(float* __restrict__ ws_state, const float* __restrict__ ws_acum, int t, int q,
               int nc, int pn) {
    const int e = blockIdx.y * kPassThreads + threadIdx.x;
    if (e >= pn) return;
    const size_t row = blockIdx.x;
    const float* acum = ws_acum + row * t;
    float* cell = ws_state + row * nc * pn + e;
    float s = 0.f;
    for (int c = 0; c < nc; ++c, cell += pn) {
        const float d = *cell;
        *cell = s;
        s = fmaf(expf(acum[c * q + q - 1]), s, d);
    }
}

// ---------------------------------------------------------------------------
// bf16 instance: mma.sync tiles fed by cp.async
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kStages = 2;        // B/x ring depth

template <int P, int N>
struct MmaTiles {
    static constexpr int NP = N < 16 ? 16 : N;  // N = 8 runs as 16 zero-padded columns
    static constexpr int LDX = P + 8;           // padded shared row of x, bf16
    static constexpr int LDN = NP + 8;          // padded shared row of B and C, bf16
    static constexpr size_t STAGE = (size_t)kT * (LDX + LDN);  // bf16 of one ring stage
    // pass 1: the chunk's a_cum, then w, (kMaxQ) and the scan's warp totals
    static constexpr size_t SMEM1 = sizeof(float) * (kMaxQ + 8) + sizeof(bf16) * kStages * STAGE;
    // pass 3: a_cum and dt of the live rows (2 x 64 x tiles), the C tile, the ring
    static size_t smem3(int tiles) {
        return sizeof(float) * 2 * (size_t)kT * tiles +
               sizeof(bf16) * ((size_t)kT * LDN + kStages * STAGE);
    }
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
// column): hi = (x, y) rounded, lo = what hi misses, rounded
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const __nv_bfloat162 r = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// rows [0, 64) of a tile starting at src (row stride W elements) into a
// padded shared tile of row stride LD; rows at or past `rows` read nothing
// and land as zeros
template <int W, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int rows) {
    constexpr int CH = W / 8;
    for (int c = threadIdx.x; c < kT * CH; c += kMmaThreads) {
        const int r = c / CH, col = (c % CH) * 8;
        const bool in = r < rows;
        cp_async_16(smem_addr(dst + r * LD + col), src + (size_t)(in ? r : 0) * W + col,
                    in ? 16 : 0);
    }
}

// zero columns [N, NP) of `count` tiles of kT rows (only when N < 16); cp.async
// never writes them
template <int N, int NP, int LD>
__device__ __forceinline__ void zero_pad_columns(bf16* tile, int count, size_t tile_stride) {
    if constexpr (N < NP) {
        for (int e = threadIdx.x; e < count * kT * (NP - N); e += kMmaThreads) {
            const int k = e / (kT * (NP - N)), r = (e / (NP - N)) % kT, col = N + e % (NP - N);
            tile[k * tile_stride + r * LD + col] = __float2bfloat16_rn(0.f);
        }
    }
}

// ldmatrix row addresses: lane l serves matrix l / 8, row l % 8
__device__ __forceinline__ int frag_row_a() {  // A (non-trans) and B (.trans)
    const int lane = threadIdx.x % 32;
    return lane % 8 + 8 * ((lane / 8) % 2);
}
__device__ __forceinline__ int frag_col_a() { return 8 * ((threadIdx.x % 32) / 16); }
__device__ __forceinline__ int frag_row_b() {  // B (non-trans)
    const int lane = threadIdx.x % 32;
    return lane % 8 + 8 * (lane / 16);
}
__device__ __forceinline__ int frag_col_b() { return 8 * (((threadIdx.x % 32) / 8) % 2); }

// Pass 1, bf16: block (row, chunk) = blockIdx.x = row * nc + chunk.
template <int P, int N>
__global__ void __launch_bounds__(kMmaThreads)
ssd_chunk_state_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const bf16* __restrict__ b,
                    float* __restrict__ ws_state, float* __restrict__ ws_acum, int t, int q) {
    using M = MmaTiles<P, N>;
    constexpr int NP = M::NP, LDX = M::LDX, LDN = M::LDN;
    constexpr int WP = P / 16 < 4 ? P / 16 : 4;  // warps along P (one 16-row block each)
    constexpr int WN = 4 / WP;                   // warps along N
    constexpr int NPAIR = NP / 16;               // 16-column pairs of n-blocks
    constexpr int PPW = (NPAIR + WN - 1) / WN;   // pairs a warp owns
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* wv = reinterpret_cast<float*>(smem_raw);  // kMaxQ: a_cum, then w
    float* red = wv + kMaxQ;                         // 4 warp totals
    bf16* ring = reinterpret_cast<bf16*>(red + 8);   // kStages x (x tile, B tile)

    const int nc = t / q;
    const int row = blockIdx.x / nc, chunk = blockIdx.x % nc;
    const size_t r0 = (size_t)row * t + (size_t)chunk * q;  // first step of the chunk
    const int tiles = (q + kT - 1) / kT;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, tq = lane % 4;
    const int pb = warp % WP, pair0 = (warp / WP) * PPW;

    zero_pad_columns<N, NP, LDN>(ring + kT * LDX, kStages, M::STAGE);
    load_tile<P, LDX>(ring, x + r0 * P, q);
    load_tile<N, LDN>(ring + kT * LDX, b + r0 * N, q);
    cp_async_commit();

    chunk_cumsum<kMmaThreads>(dt + r0, a[row], q, wv, red);
    const float total = wv[q - 1];
    __syncthreads();  // every thread has read the total before w overwrites a_cum
    for (int i = threadIdx.x; i < tiles * kT; i += kMmaThreads) {
        if (i < q) {
            const float ac = wv[i];
            ws_acum[r0 + i] = ac;
            wv[i] = dt[r0 + i] * expf(total - ac);
        } else {
            wv[i] = 0.f;
        }
    }

    float acc[2 * PPW][4];
#pragma unroll
    for (int j = 0; j < 2 * PPW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    // x^T's A fragment: matrix l / 8 of lane l is rows (steps) 8 (l / 16).., columns
    // (P) 8 ((l / 8) % 2).. of x, the B-operand pattern; B's as V's in K3
    const int ar = frag_row_a(), ac = frag_col_a(), br = frag_row_b(), bc = frag_col_b();

    for (int tt = 0; tt < tiles; ++tt) {
        const int stage = tt % kStages;
        cp_async_wait_all();
        __syncthreads();  // tile tt (and w) landed; every warp is done with the other stage
        if (tt + 1 < tiles) {
            bf16* nxt = ring + ((tt + 1) % kStages) * M::STAGE;
            const int s0 = (tt + 1) * kT;
            load_tile<P, LDX>(nxt, x + (r0 + s0) * P, q - s0);
            load_tile<N, LDN>(nxt + kT * LDX, b + (r0 + s0) * N, q - s0);
        }
        cp_async_commit();
        const bf16* xs = ring + stage * M::STAGE;
        const bf16* bs = xs + kT * LDX;
        const int steps = (min(kT, q - tt * kT) + 15) / 16;  // 16-row steps holding a row
        for (int kk = 0; kk < steps; ++kk) {
            // (w o x)^T of rows 16 kk.. as the A operand: x^T by ldmatrix.trans,
            // each element scaled by w of its step, then split
            uint32_t xa[4], hi[4], lo[4];
            ldmatrix_x4_trans(xa, smem_addr(xs + (16 * kk + br) * LDX + 16 * pb + bc));
            const float* w = wv + tt * kT + 16 * kk + 2 * tq;
            const float w0 = w[0], w1 = w[1], w8 = w[8], w9 = w[9];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float2 v = unpack_bf16(xa[r]);
                if (r < 2) split_bf16(v.x * w0, v.y * w1, hi[r], lo[r]);
                else split_bf16(v.x * w8, v.y * w9, hi[r], lo[r]);
            }
#pragma unroll
            for (int j = 0; j < PPW; ++j) {
                const int pr = pair0 + j;
                if (pr >= NPAIR) continue;
                uint32_t bb[4];
                ldmatrix_x4_trans(bb, smem_addr(bs + (16 * kk + ar) * LDN + 16 * pr + ac));
                mma_bf16(acc[2 * j], hi, bb[0], bb[1]);
                mma_bf16(acc[2 * j + 1], hi, bb[2], bb[3]);
                mma_bf16(acc[2 * j], lo, bb[0], bb[1]);
                mma_bf16(acc[2 * j + 1], lo, bb[2], bb[3]);
            }
        }
    }

    float* out = ws_state + (size_t)blockIdx.x * P * N;
#pragma unroll
    for (int j = 0; j < 2 * PPW; ++j) {
        const int n = (2 * pair0 + j) * 8 + 2 * tq;
        if (n >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int p = 16 * pb + g + 8 * h;
            *reinterpret_cast<float2*>(out + (size_t)p * N + n) =
                make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        }
    }
}

// Pass 3, bf16: block (row * nc + chunk, query tile), the last tiles first.
template <int P, int N>
__global__ void __launch_bounds__(kMmaThreads, 3)
ssd_chunk_scan_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const bf16* __restrict__ b, const bf16* __restrict__ c,
                   const float* __restrict__ ws_state, const float* __restrict__ ws_acum,
                   bf16* __restrict__ y, int t, int q) {
    using M = MmaTiles<P, N>;
    constexpr int NP = M::NP, LDX = M::LDX, LDN = M::LDN;
    constexpr int KN = NP / 16;  // k-steps over the state dimension
    constexpr int NX = P / 8;    // 8-wide column blocks of y
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int it = gridDim.y - 1 - blockIdx.y;  // query tile
    const int live = (it + 1) * kT;             // steps of the chunk this tile reads
    float* acum = reinterpret_cast<float*>(smem_raw);  // live
    float* dts = acum + live;                           // live
    bf16* cs = reinterpret_cast<bf16*>(dts + live);     // kT x LDN
    bf16* ring = cs + kT * LDN;                         // kStages x (B tile, x tile)

    const int nc = t / q;
    const int row = blockIdx.x / nc;
    const size_t r0 = (size_t)row * t + (size_t)(blockIdx.x % nc) * q;
    const int i0 = it * kT;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, tq = lane % 4;
    const int qw0 = i0 + 16 * warp;  // this warp's first query row in the chunk

    zero_pad_columns<N, NP, LDN>(cs, 1, 0);
    zero_pad_columns<N, NP, LDN>(ring, kStages, M::STAGE);
    load_tile<N, LDN>(cs, c + (r0 + i0) * N, q - i0);
    load_tile<N, LDN>(ring, b + r0 * N, q);
    load_tile<P, LDX>(ring + kT * LDN, x + r0 * P, q);
    cp_async_commit();
    for (int i = threadIdx.x; i < live; i += kMmaThreads) {
        acum[i] = i < q ? ws_acum[r0 + i] : 0.f;
        dts[i] = i < q ? dt[r0 + i] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    const int ar = frag_row_a(), ac = frag_col_a(), br = frag_row_b(), bc = frag_col_b();
    const bf16* c_frag = cs + (16 * warp + ar) * LDN + ac;
    const bool active = qw0 < q;  // some row of this warp is in the chunk

    // the state term: exp(a_cum_i) (C_i S^T), S's fragments from the workspace
    float acc[NX][4];
#pragma unroll
    for (int j = 0; j < NX; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (active) {
        const float* st = ws_state + (size_t)blockIdx.x * P * N;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
            uint32_t ca[4];
            ldmatrix_x4(ca, smem_addr(c_frag + 16 * kk));
            const int k = 16 * kk + 2 * tq;
#pragma unroll
            for (int j = 0; j < NX; ++j) {
                const float* sp = st + (size_t)(8 * j + g) * N + k;
                const float2 s0 = __ldg(reinterpret_cast<const float2*>(sp));
                const float2 s1 = k + 8 < N ? __ldg(reinterpret_cast<const float2*>(sp + 8))
                                            : make_float2(0.f, 0.f);
                uint32_t h0, l0, h1, l1;
                split_bf16(s0.x, s0.y, h0, l0);
                split_bf16(s1.x, s1.y, h1, l1);
                mma_bf16(acc[j], ca, h0, h1);
                mma_bf16(acc[j], ca, l0, l1);
            }
        }
        const float d0 = expf(acum[qw0 + g]), d1 = expf(acum[qw0 + g + 8]);
#pragma unroll
        for (int j = 0; j < NX; ++j) acc[j][0] *= d0, acc[j][1] *= d0, acc[j][2] *= d1, acc[j][3] *= d1;
    }

    for (int jt = 0; jt <= it; ++jt) {
        const int stage = jt % kStages;
        cp_async_wait_all();
        // tile jt has landed for every thread, and every warp is done with the
        // stage that the next copy overwrites
        __syncthreads();
        if (jt < it) {
            bf16* nxt = ring + ((jt + 1) % kStages) * M::STAGE;
            const int j0n = (jt + 1) * kT;
            load_tile<N, LDN>(nxt, b + (r0 + j0n) * N, q - j0n);
            load_tile<P, LDX>(nxt + kT * LDN, x + (r0 + j0n) * P, q - j0n);
        }
        cp_async_commit();
        if (!active) continue;
        const int j0 = jt * kT;
        const bf16* bst = ring + stage * M::STAGE;
        const bf16* xst = bst + kT * LDN;

        // S = C_i B_j^T for rows qw0 + g (+ 8), keys j0 + 8 n + 2 tq (+ 1)
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
            uint32_t ca[4];
            ldmatrix_x4(ca, smem_addr(c_frag + 16 * kk));
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                uint32_t bb[4];
                ldmatrix_x4(bb, smem_addr(bst + (16 * n + br) * LDN + 16 * kk + bc));
                mma_bf16(s[2 * n], ca, bb[0], bb[1]);
                mma_bf16(s[2 * n + 1], ca, bb[2], bb[3]);
            }
        }
        // G = S o L o dt_j, zero above the diagonal and past the chunk
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int qi = qw0 + g + 8 * h;
            const float ai = acum[qi];
#pragma unroll
            for (int n = 0; n < 8; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int kj = j0 + 8 * n + 2 * tq + e;
                    const bool keep = kj <= qi && qi < q;
                    s[n][2 * h + e] = keep ? s[n][2 * h + e] * expf(ai - acum[kj]) * dts[kj] : 0.f;
                }
        }
        // y += G x_j with G as bf16 hi + lo, each used in place as the A
        // operand (the m16n8 accumulator layout is the m16n8k16 A layout)
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {
            uint32_t hi[4], lo[4];
            split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
            split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
            split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
            split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
            for (int dn = 0; dn < P / 16; ++dn) {
                uint32_t bb[4];
                ldmatrix_x4_trans(bb, smem_addr(xst + (16 * kk + ar) * LDX + 16 * dn + ac));
                mma_bf16(acc[2 * dn], hi, bb[0], bb[1]);
                mma_bf16(acc[2 * dn + 1], hi, bb[2], bb[3]);
                mma_bf16(acc[2 * dn], lo, bb[0], bb[1]);
                mma_bf16(acc[2 * dn + 1], lo, bb[2], bb[3]);
            }
        }
    }

    if (!active) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int qi = qw0 + g + 8 * h;
        if (qi >= q) continue;
        bf16* yr = y + (r0 + qi) * P + 2 * tq;
#pragma unroll
        for (int j = 0; j < NX; ++j)
            *reinterpret_cast<__nv_bfloat162*>(yr + 8 * j) =
                __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
    }
}

// ---------------------------------------------------------------------------
// f32 instance: SIMT FMAs on the same grid
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;  // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kGL = kT + 1;    // padded row of the G tile

template <int P, int N>
struct SimtTiles {
    static constexpr int NL = N + 1;  // padded row of B, C and S
    // pass 1: a_cum then w (kMaxQ), warp totals, w o x tile, B tile
    static constexpr size_t SMEM1 =
        sizeof(float) * ((size_t)kMaxQ + kWarps + (size_t)kT * P + (size_t)kT * NL);
    // pass 3: S, C tile, B tile, dt o x tile, G tile, a_cum of the live rows
    static size_t smem3(int live) {
        return sizeof(float) * ((size_t)P * NL + 2 * (size_t)kT * NL + (size_t)kT * P +
                                (size_t)kT * kGL + live);
    }
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_simt(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ ws_state, float* __restrict__ ws_acum, int t, int q) {
    constexpr int NL = SimtTiles<P, N>::NL;
    constexpr int SE = (P * N + kThreads - 1) / kThreads;  // state entries a thread owns
    extern __shared__ float smem[];
    float* wv = smem;           // kMaxQ
    float* red = wv + kMaxQ;    // kWarps
    float* xs = red + kWarps;   // kT x P: w o x
    float* bs = xs + kT * P;    // kT x NL
    const int tid = threadIdx.x;
    const int nc = t / q;
    const int row = blockIdx.x / nc;
    const size_t r0 = (size_t)row * t + (size_t)(blockIdx.x % nc) * q;

    chunk_cumsum<kThreads>(dt + r0, a[row], q, wv, red);
    const float total = wv[q - 1];
    __syncthreads();
    for (int i = tid; i < q; i += kThreads) {
        const float ac = wv[i];
        ws_acum[r0 + i] = ac;
        wv[i] = dt[r0 + i] * expf(total - ac);
    }
    float sacc[SE];
#pragma unroll
    for (int k = 0; k < SE; ++k) sacc[k] = 0.f;
    for (int s0 = 0; s0 < q; s0 += kT) {
        const int rows = min(kT, q - s0);
        __syncthreads();  // w is whole; earlier readers of xs and bs are done
        for (int e = tid; e < rows * P; e += kThreads)
            xs[e] = x[(r0 + s0) * P + e] * wv[s0 + e / P];
        for (int e = tid; e < rows * N; e += kThreads)
            bs[(e / N) * NL + e % N] = b[(r0 + s0) * N + e];
        __syncthreads();
#pragma unroll
        for (int k = 0; k < SE; ++k) {
            const int e = tid + k * kThreads;
            if (e < P * N) {
                const int p = e / N, n = e % N;
                float acc = sacc[k];
                for (int s = 0; s < rows; ++s) acc = fmaf(xs[s * P + p], bs[s * NL + n], acc);
                sacc[k] = acc;
            }
        }
    }
    float* out = ws_state + (size_t)blockIdx.x * P * N;
#pragma unroll
    for (int k = 0; k < SE; ++k) {
        const int e = tid + k * kThreads;
        if (e < P * N) out[e] = sacc[k];
    }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_simt(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ b, const float* __restrict__ c,
                    const float* __restrict__ ws_state, const float* __restrict__ ws_acum,
                    float* __restrict__ y, int t, int q) {
    constexpr int NL = SimtTiles<P, N>::NL;
    constexpr int RC = P / 16;  // y columns a thread owns
    extern __shared__ float smem[];
    const int it = gridDim.y - 1 - blockIdx.y;  // query tile, the last first
    const int i0 = it * kT;
    const int live = min(q, i0 + kT);
    float* st = smem;              // P x NL: the state entering the chunk
    float* cs = st + P * NL;       // kT x NL: C of the query tile
    float* bs = cs + kT * NL;      // kT x NL: B of the key tile
    float* xs = bs + kT * NL;      // kT x P: dt o x of the key tile
    float* gs = xs + kT * P;       // kT x kGL: (C B^T) o L
    float* acum = gs + kT * kGL;   // live

    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int nc = t / q;
    const size_t r0 = (size_t)(blockIdx.x / nc) * t + (size_t)(blockIdx.x % nc) * q;
    const float* sg = ws_state + (size_t)blockIdx.x * P * N;
    for (int e = tid; e < P * N; e += kThreads) st[(e / N) * NL + e % N] = sg[e];
    for (int i = tid; i < live; i += kThreads) acum[i] = ws_acum[r0 + i];
    for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, n = e % N;
        cs[r * NL + n] = i0 + r < q ? c[(r0 + i0 + r) * N + n] : 0.f;
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
        const int qi = i0 + ty + 16 * r;
        const float dfs = qi < q ? expf(acum[qi]) : 0.f;
#pragma unroll
        for (int cc = 0; cc < RC; ++cc) yacc[r][cc] *= dfs;
    }

    for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();  // earlier readers of bs, xs, gs are done
        for (int e = tid; e < kT * N; e += kThreads) {
            const int r = e / N, n = e % N;
            bs[r * NL + n] = j0 + r < q ? b[(r0 + j0 + r) * N + n] : 0.f;
        }
        for (int e = tid; e < kT * P; e += kThreads) {
            const int r = e / P;
            xs[e] = j0 + r < q ? x[(r0 + j0) * P + e] * dt[r0 + j0 + r] : 0.f;
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
                const int qi = i0 + ty + 16 * r, kj = j0 + tx + 16 * s;
                const bool keep = kj <= qi && qi < q;
                gs[(ty + 16 * r) * kGL + tx + 16 * s] =
                    keep ? g[r][s] * expf(acum[qi] - acum[kj]) : 0.f;
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
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int qi = i0 + ty + 16 * r;
        if (qi >= q) continue;
#pragma unroll
        for (int cc = 0; cc < RC; ++cc) y[(r0 + qi) * P + tx + 16 * cc] = yacc[r][cc];
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
struct Problem {
    const void* x;
    const float* dt;
    const float* a;
    const void* b;
    const void* c;
    void* y;
    float* ws_state;  // (bh, nc, p, n)
    float* ws_acum;   // (bh, t)
    int bh, t, q, nc, tiles;
    cudaStream_t stream;
};

int launch_pass2(const Problem& pr, int pn) {
    const dim3 grid((unsigned)pr.bh, (unsigned)((pn + kPassThreads - 1) / kPassThreads));
    ssd_state_pass<<<grid, kPassThreads, 0, pr.stream>>>(pr.ws_state, pr.ws_acum, pr.t, pr.q,
                                                         pr.nc, pn);
    return (int)cudaGetLastError();
}

template <int P, int N>
int launch_mma(const Problem& pr) {
    using M = MmaTiles<P, N>;
    static bool conf1[kMaxDevices] = {}, conf3[kMaxDevices] = {};
    int rc = configure_once((const void*)ssd_chunk_state_mma<P, N>, M::SMEM1, conf1);
    if (rc == 0)
        rc = configure_once((const void*)ssd_chunk_scan_mma<P, N>, M::smem3(kMaxQ / kT), conf3);
    if (rc != 0) return rc;
    const unsigned blocks = (unsigned)(pr.bh * pr.nc);
    ssd_chunk_state_mma<P, N><<<blocks, kMmaThreads, M::SMEM1, pr.stream>>>(
        static_cast<const bf16*>(pr.x), pr.dt, pr.a, static_cast<const bf16*>(pr.b),
        pr.ws_state, pr.ws_acum, pr.t, pr.q);
    rc = (int)cudaGetLastError();
    if (rc == 0) rc = launch_pass2(pr, P * N);
    if (rc != 0) return rc;
    ssd_chunk_scan_mma<P, N><<<dim3(blocks, (unsigned)pr.tiles), kMmaThreads,
                               M::smem3(pr.tiles), pr.stream>>>(
        static_cast<const bf16*>(pr.x), pr.dt, static_cast<const bf16*>(pr.b),
        static_cast<const bf16*>(pr.c), pr.ws_state, pr.ws_acum, static_cast<bf16*>(pr.y),
        pr.t, pr.q);
    return (int)cudaGetLastError();
}

template <int P, int N>
int launch_simt(const Problem& pr) {
    using S = SimtTiles<P, N>;
    static bool conf1[kMaxDevices] = {}, conf3[kMaxDevices] = {};
    int rc = configure_once((const void*)ssd_chunk_state_simt<P, N>, S::SMEM1, conf1);
    if (rc == 0)
        rc = configure_once((const void*)ssd_chunk_scan_simt<P, N>, S::smem3(kMaxQ), conf3);
    if (rc != 0) return rc;
    const unsigned blocks = (unsigned)(pr.bh * pr.nc);
    ssd_chunk_state_simt<P, N><<<blocks, kThreads, S::SMEM1, pr.stream>>>(
        static_cast<const float*>(pr.x), pr.dt, pr.a, static_cast<const float*>(pr.b),
        pr.ws_state, pr.ws_acum, pr.t, pr.q);
    rc = (int)cudaGetLastError();
    if (rc == 0) rc = launch_pass2(pr, P * N);
    if (rc != 0) return rc;
    ssd_chunk_scan_simt<P, N><<<dim3(blocks, (unsigned)pr.tiles), kThreads,
                                S::smem3(min(pr.q, kT * pr.tiles)), pr.stream>>>(
        static_cast<const float*>(pr.x), pr.dt, static_cast<const float*>(pr.b),
        static_cast<const float*>(pr.c), pr.ws_state, pr.ws_acum, static_cast<float*>(pr.y),
        pr.t, pr.q);
    return (int)cudaGetLastError();
}

template <bool MMA, int P>
int dispatch_n(const Problem& pr, int64_t n) {
#define REPRO_SSD_N(N) \
    case N: return MMA ? launch_mma<P, N>(pr) : launch_simt<P, N>(pr);
    switch (n) {
        REPRO_SSD_N(8)
        REPRO_SSD_N(16)
        REPRO_SSD_N(32)
        REPRO_SSD_N(64)
        REPRO_SSD_N(128)
        default: return (int)cudaErrorInvalidValue;
    }
#undef REPRO_SSD_N
}

template <bool MMA>
int dispatch_p(const Problem& pr, int64_t p, int64_t n) {
    switch (p) {
        case 16: return dispatch_n<MMA, 16>(pr, n);
        case 32: return dispatch_n<MMA, 32>(pr, n);
        case 64: return dispatch_n<MMA, 64>(pr, n);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  x is a contiguous (bh, t, p)
// array, b and c (bh, t, n), y (bh, t, p), all of one dtype (0 = float32,
// the SIMT instance; 1 = bfloat16, the tensor-core instance, which needs
// 16-byte aligned arrays, as every allocation is); dt is (bh, t) float32
// after softplus and a is (bh,) float32 (negative decay rates).  q is the
// chunk: 1 <= q <= 1024 and t % q == 0.  ws is a float32 workspace of
// bh * (t / q) * p * n + bh * t floats (the chunk states, then the
// cumulative decays), 8-byte aligned.  The three passes are launched in
// order on `stream`.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape, dtype or alignment the kernel does not
// take; an empty problem launches nothing.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a, const void* b,
                              const void* c, void* y, void* ws, int64_t bh, int64_t t,
                              int64_t p, int64_t n, int64_t q, int dtype, cudaStream_t stream) {
    if (bh == 0 || t == 0) return 0;
    if (bh < 0 || bh > INT_MAX || t < 0 || t > INT_MAX || q < 1 || q > kMaxQ || t % q ||
        bh * (t / q) > INT_MAX)
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)ws % 8) return (int)cudaErrorInvalidValue;
    const int nc = (int)(t / q);
    float* wsf = static_cast<float*>(ws);
    const Problem pr{x, static_cast<const float*>(dt), static_cast<const float*>(a), b, c, y,
                     wsf, wsf + (size_t)bh * nc * p * n, (int)bh, (int)t, (int)q, nc,
                     (int)((q + kT - 1) / kT), stream};
    if (dtype == 0) return dispatch_p<false>(pr, p, n);
    if (dtype == 1) {
        const uintptr_t any = (uintptr_t)x | (uintptr_t)b | (uintptr_t)c | (uintptr_t)y;
        if (any % 16) return (int)cudaErrorInvalidValue;
        return dispatch_p<true>(pr, p, n);
    }
    return (int)cudaErrorInvalidValue;
}
