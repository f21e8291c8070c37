// Expert positions of the MoE router, for Hopper (sm_90a).
//
// This kernel replaces no Pallas kernel: the JAX package computes the same
// positions with `jnp.cumsum` over a one-hot matrix
// (src/repro/models/moe.py, `route_topk`), which XLA fuses.  The port's
// plain PyTorch version (`kernels/moe_route.py::expert_slots_torch`) builds
// the int64 (n·k, E) one-hot matrix and scans it down its rows, and PyTorch
// scans a non-innermost dimension with one thread per column walking every
// row in turn: at granite_moe_1b's full batch (n 15,872 tokens, k 8, E 32)
// that scan took ~27 ms a layer, about three quarters of the model's device
// time in a served prefill.
//
// What it computes.  For each of L independent routings, over the routing's
// m = n·k choices in flattened token-major order, with e = eids[i] and
//
//     pos(i)  = #{ i' < i : eids[i'] == e }         (its rank within e)
//     slot(i) = e·C + pos(i)  if pos(i) < C,  else E·C  (dropped)
//
// exactly what the one-hot cumsum gives.  An id outside [0, E) is counted by
// no expert and its slot reads E·C (the plain version raises for it; top-k
// over E logits never gives one).
//
// Determinism.  Positions are ranks in token order, never the order in which
// atomics arrive, so the same choices drop on every run: a counting scan.
//   pass 1 `expert_count_kernel`: one block a tile of kTile consecutive
//     choices, one histogram of the tile per expert (shared-memory atomics:
//     integer adds commute, so the counts are exact in any order);
//   pass 2 `expert_slot_kernel`: the same tiles.  Each warp owns kWarpSpan
//     consecutive choices of its tile and counts them per expert; thread e
//     adds up expert e's counts of the earlier tiles (pass 1) and of the
//     earlier warps, the base of each warp; then each warp walks its choices
//     32 at a time, and `__match_any_sync` groups the lanes that hold one
//     expert: a lane's rank is its group's lanes below it plus the warp's
//     running count of that expert, which the group's lowest lane advances.
// A routing of one tile (a decode step: n rows, every choice fits) skips
// pass 1.
//
// Bound.  The work reads the (L, n, k) int32 ids and writes the int32 slots,
// 8 bytes a choice: ~1 MB at granite's full batch, ~0.3 us at 3.35 TB/s, so
// the launches set the time.  Each thread holds kItems ids in registers from
// one coalesced load a step and reads the ids once; the tile counts of pass 1
// are L·tiles·E ints (8 KB at granite's full batch).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                    // ids a thread holds
constexpr int kWarpSpan = 32 * kItems;       // consecutive choices a warp owns
constexpr int kTile = kThreads * kItems;     // consecutive choices a block owns
constexpr int kMaxExperts = 256;

// The ids of one tile into registers: lane j of warp w holds, at step s,
// choice w·kWarpSpan + 32·s + j of the tile (-1 past the end or out of range).
__device__ __forceinline__ void load_tile(const int* __restrict__ eids, int64_t m, int64_t start,
                                          int warp, int lane, int n_experts, int (&v)[kItems]) {
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
        const int64_t i = start + warp * kWarpSpan + 32 * s + lane;
        const int x = i < m ? eids[i] : -1;
        v[s] = (x >= 0 && x < n_experts) ? x : -1;
    }
}

__global__ void __launch_bounds__(kThreads) expert_count_kernel(
    const int* __restrict__ eids, int64_t m, int n_experts, int* __restrict__ counts) {
    __shared__ int hist[kMaxExperts];
    const int tile = blockIdx.x, l = blockIdx.y;
    for (int e = threadIdx.x; e < n_experts; e += kThreads) hist[e] = 0;
    __syncthreads();
    int v[kItems];
    load_tile(eids + l * m, m, (int64_t)tile * kTile, threadIdx.x / 32, threadIdx.x % 32,
              n_experts, v);
#pragma unroll
    for (int s = 0; s < kItems; ++s)
        if (v[s] >= 0) atomicAdd(&hist[v[s]], 1);
    __syncthreads();
    int* out = counts + ((int64_t)l * gridDim.x + tile) * n_experts;
    for (int e = threadIdx.x; e < n_experts; e += kThreads) out[e] = hist[e];
}

__global__ void __launch_bounds__(kThreads) expert_slot_kernel(
    const int* __restrict__ eids, int64_t m, int n_experts, int capacity,
    const int* __restrict__ counts, int* __restrict__ slot) {
    __shared__ int base[kWarps][kMaxExperts];  // per warp: its running count of each expert
    const int tile = blockIdx.x, l = blockIdx.y;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int i = threadIdx.x; i < kWarps * kMaxExperts; i += kThreads) (&base[0][0])[i] = 0;
    __syncthreads();
    int v[kItems];
    const int64_t start = (int64_t)tile * kTile;
    load_tile(eids + l * m, m, start, warp, lane, n_experts, v);
#pragma unroll
    for (int s = 0; s < kItems; ++s)
        if (v[s] >= 0) atomicAdd(&base[warp][v[s]], 1);
    __syncthreads();
    // exclusive prefix per expert: the earlier tiles, then the earlier warps
    for (int e = threadIdx.x; e < n_experts; e += kThreads) {
        const int* c = counts + (int64_t)l * gridDim.x * n_experts + e;
        int run = 0;
        for (int t = 0; t < tile; ++t) run += c[(int64_t)t * n_experts];
        for (int w = 0; w < kWarps; ++w) {
            const int x = base[w][e];
            base[w][e] = run;
            run += x;
        }
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
    const int dropped = n_experts * capacity;
    int* out = slot + l * m;
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
        const int e = v[s];
        const unsigned peers = __match_any_sync(0xffffffffu, e);
        const int pos = e >= 0 ? base[warp][e] + __popc(peers & below) : 0;
        __syncwarp();  // every lane of the group has read the count
        if (e >= 0 && (peers & below) == 0) base[warp][e] += __popc(peers);
        __syncwarp();
        const int64_t i = start + warp * kWarpSpan + 32 * s + lane;
        if (i < m) out[i] = (e >= 0 && pos < capacity) ? e * capacity + pos : dropped;
    }
}

}  // namespace

// Plain C entry points, loaded with ctypes; each returns a CUDA error code.

// Choices a tile holds, so the caller can size the tile counts.
extern "C" int repro_expert_slots_tile() { return kTile; }

// eids, slot: (n_routings, m) int32, contiguous; counts: n_routings ·
// ceil(m / tile) · n_experts int32 of scratch (unread when one tile holds m).
// Two launches on `stream` (one for a single tile), no synchronisation;
// returns cudaGetLastError() after them, or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int repro_expert_slots(const int* eids, int* slot, int* counts, int64_t n_routings,
                                  int64_t m, int n_experts, int capacity, cudaStream_t stream) {
    if (n_routings == 0 || m == 0) return 0;
    const int64_t tiles = (m + kTile - 1) / kTile;
    if (n_routings < 0 || n_routings > 65535 || m < 0 || tiles > 0x7fffffff || n_experts < 1 ||
        n_experts > kMaxExperts || capacity < 0 ||
        (int64_t)n_experts * capacity > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles, (unsigned)n_routings);
    if (tiles > 1) {
        expert_count_kernel<<<grid, kThreads, 0, stream>>>(eids, m, n_experts, counts);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    expert_slot_kernel<<<grid, kThreads, 0, stream>>>(eids, m, n_experts, capacity, counts, slot);
    return (int)cudaGetLastError();
}
