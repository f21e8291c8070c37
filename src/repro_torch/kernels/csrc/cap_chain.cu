// Cap-chain kernels of the vector flow engine, for Hopper (sm_90a).
//
// K1 `cap_chain_rates_kernel` replaces the Pallas kernel `_cap_chain_kernel`
// (src/repro/kernels/cap_chain.py, reached through `_cap_chain_call` and
// `cap_chain_rates`).  For every flow of one wide recompute front it computes
//
//     rate = min(per_stream_cap, out_cap / n_out, in_cap / n_in,
//                decompress_rate, [blk] (block_size * qps) / n_out, par_rate)
//
// Bit-identity with the numpy engine is the contract, so every operation is
// the IEEE double operation numpy performs, in numpy's operand order:
// divisions and the one product are round-to-nearest (`__ddiv_rn`,
// `__dmul_rn`), the library is built with --fmad=false so nothing is
// contracted, and the minimum propagates NaN like `np.minimum` (which `fmin`
// does not).  The block throttle is computed for every lane and selected by
// `blk`, as the Pallas kernel does; that equals numpy's masked update.
//
// The kernel is bound by memory: per flow it reads two int64 counts, three
// doubles and one byte of `blk` and writes one double, 49 bytes.  A front of
// ~900 flows is ~44 KB, nanoseconds at 3.35 TB/s, so the launch and the
// host<->device copies of the front set its time.  One thread per flow with a
// grid-stride loop and a masked ragged tail is all the work needs; the TPU
// version's padding to 256-lane blocks is gone.
//
// The engine's route is `repro_cap_chain_front`: the front's operands arrive
// packed in one pinned host buffer (six segments of n values: n_out, n_in as
// int64, out_cap, qps, par_rate as double, blk as bytes, each at a multiple
// of 8 bytes), so one ctypes call makes one host-to-device copy, the launch,
// one device-to-host copy of the rates into pinned memory and the
// synchronisation, where six pageable copies, a few tensor allocations and a
// blocking copy back took ~0.2 ms a front.
//
// K2 `nic_flow_counts_kernel` replaces the Pallas kernel `_count_kernel`
// (same file, reached through `_count_call` and `nic_flow_counts`): the
// per-NIC active-flow count, a bincount of int64 ids into int64 counts.
// Integer atomics commute, so the result is exact and deterministic whatever
// the order of the adds.  Contention is low: on the giga tier's plan (1 M
// flows, 100,001 NICs, 99,649 of them sources) no NIC has more than 28
// flows, and 32 consecutive flows have 17 distinct sources on average
// (median 17).  One 8-byte load and one global atomic a flow would make
// ~1 M separate L2 atomics.  Here a thread loads two ids with one 16-byte
// load (one id peeled at the head when the array is only 8-byte aligned, a
// scalar tail when the rest is odd); a warp's 32 lanes then hold 64
// consecutive ids, and shuffles hand lane l ids l and 32 + l, so that each
// half of the 64 sits in lane order.  In each half, a run of equal ids adds
// its length with one atomicAdd from its first lane (a shuffle and two
// ballots): 0.53 atomics a flow on the giga plan, whose flows come as
// x0 x1 x1 x2 x2 ....  `__match_any_sync` over the same 32 lanes groups
// exactly as much there (each id's repeats are adjacent) and cost ~2.5 us
// more a call on an H100; matching each lane's two adjacent ids merged nothing.  The
// grid is one wave at 4 blocks of 256 threads on each SM.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks on each SM
constexpr int64_t kCountBlocks = 132 * 4;  // K2: one wave, 4 blocks on each SM

__device__ __forceinline__ double min_nan(double a, double b) {
    // np.minimum: a NaN in either operand gives NaN.
    return (a != a || a <= b) ? a : b;
}

__global__ void cap_chain_rates_kernel(
    const int64_t* __restrict__ n_out, const int64_t* __restrict__ n_in,
    const double* __restrict__ out_cap, const double* __restrict__ qps,
    const double* __restrict__ par_rate, const unsigned char* __restrict__ blk,
    double* __restrict__ rate, int64_t n, double per_stream_cap,
    double in_cap, double decompress_rate, double block_size) {
    const int64_t stride = (int64_t)blockDim.x * gridDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        // Counts are far below 2^53, so the conversion is exact.
        const double no = (double)n_out[i];
        double r = min_nan(per_stream_cap, __ddiv_rn(out_cap[i], no));
        r = min_nan(r, __ddiv_rn(in_cap, (double)n_in[i]));
        r = min_nan(r, decompress_rate);
        const double throttled =
            min_nan(r, __ddiv_rn(__dmul_rn(block_size, qps[i]), no));
        r = blk[i] ? throttled : r;
        rate[i] = min_nan(r, par_rate[i]);
    }
}

// Lanes hold consecutive flows in lane order.  Each run of equal ids among
// the `ok` lanes adds its length with one atomic, from its first lane.
__device__ __forceinline__ void add_runs(unsigned long long* counts, unsigned long long id,
                                         bool ok, int lane) {
    const unsigned long long prev = __shfl_up_sync(0xffffffffu, id, 1);
    const bool start = ok && (lane == 0 || prev != id);
    const unsigned starts = __ballot_sync(0xffffffffu, start);
    const unsigned live = __ballot_sync(0xffffffffu, ok);  // lanes [0, k)
    if (!start) return;
    const unsigned later = starts & ~((2u << lane) - 1u);  // runs after this one
    const int end = later ? __ffs(later) - 1 : 32 - __clz(live);
    atomicAdd(&counts[id], (unsigned long long)(end - lane));
}

__global__ void nic_flow_counts_kernel(const int64_t* __restrict__ nodes,
                                       int64_t n,
                                       unsigned long long* __restrict__ counts) {
    const int lane = threadIdx.x % 32;
    const int64_t head = reinterpret_cast<uintptr_t>(nodes) % 16 ? 1 : 0;
    const longlong2* __restrict__ pairs = reinterpret_cast<const longlong2*>(nodes + head);
    const int64_t n2 = (n - head) / 2;
    const int64_t stride = (int64_t)blockDim.x * gridDim.x;
    const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (first == 0) {
        if (head) atomicAdd(&counts[nodes[0]], 1ULL);
        if ((n - head) & 1) atomicAdd(&counts[nodes[n - 1]], 1ULL);
    }
    // A warp takes 32 pairs, ids [2 i0, 2 i0 + 64): lane l loads ids 2l and
    // 2l + 1, then takes ids l and 32 + l by shuffles, so each aggregation
    // runs over 32 consecutive flows, where the plan's repeats are.  The loop test
    // is the warp's, so every lane takes part in the shuffles.
    for (int64_t i0 = first - lane; i0 < n2; i0 += stride) {
        const int64_t i = i0 + lane;
        const longlong2 p = i < n2 ? pairs[i] : make_longlong2(0, 0);
        const int src = lane >> 1;
        const long long a0 = __shfl_sync(0xffffffffu, p.x, src);
        const long long b0 = __shfl_sync(0xffffffffu, p.y, src);
        const long long a1 = __shfl_sync(0xffffffffu, p.x, src + 16);
        const long long b1 = __shfl_sync(0xffffffffu, p.y, src + 16);
        const int64_t ids = 2 * (n2 - i0 < 32 ? n2 - i0 : 32);  // ids this warp holds
        add_runs(counts, (unsigned long long)(lane & 1 ? b0 : a0), lane < ids, lane);
        add_runs(counts, (unsigned long long)(lane & 1 ? b1 : a1), 32 + lane < ids, lane);
    }
}

int blocks_for(int64_t n) {
    const int64_t b = (n + kThreads - 1) / kThreads;
    return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each returns cudaGetLastError()
// after its launch (0 on success), so a refused launch is reported to the
// caller; a grid of 0 blocks is invalid, so n == 0 launches nothing.
extern "C" int repro_cap_chain_rates(
    const int64_t* n_out, const int64_t* n_in, const double* out_cap,
    const double* qps, const double* par_rate, const unsigned char* blk,
    double* rate, int64_t n, double per_stream_cap, double in_cap,
    double decompress_rate, double block_size, cudaStream_t stream) {
    if (n == 0) return 0;
    cap_chain_rates_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        n_out, n_in, out_cap, qps, par_rate, blk, rate, n, per_stream_cap,
        in_cap, decompress_rate, block_size);
    return (int)cudaGetLastError();
}

// Bytes of one packed front of n flows: five 8-byte segments, then blk.
static int64_t packed_front_bytes(int64_t n) { return 40 * n + ((n + 7) / 8) * 8; }

// One front, packed: host_in (pinned, packed_front_bytes(n) bytes as laid out
// above) -> dev_in, the kernel into dev_out (n doubles), dev_out -> host_out
// (pinned), then a synchronisation of `stream`, so host_out holds the rates
// on return.  Returns the first CUDA error, 0 on success.
extern "C" int repro_cap_chain_front(
    const void* host_in, void* dev_in, double* dev_out, double* host_out, int64_t n,
    double per_stream_cap, double in_cap, double decompress_rate, double block_size,
    cudaStream_t stream) {
    if (n == 0) return 0;
    if (n < 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemcpyAsync(dev_in, host_in, packed_front_bytes(n),
                                      cudaMemcpyHostToDevice, stream);
    if (err != cudaSuccess) return (int)err;
    const unsigned char* base = static_cast<const unsigned char*>(dev_in);
    cap_chain_rates_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        reinterpret_cast<const int64_t*>(base), reinterpret_cast<const int64_t*>(base + 8 * n),
        reinterpret_cast<const double*>(base + 16 * n),
        reinterpret_cast<const double*>(base + 24 * n),
        reinterpret_cast<const double*>(base + 32 * n), base + 40 * n, dev_out, n,
        per_stream_cap, in_cap, decompress_rate, block_size);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaMemcpyAsync(host_out, dev_out, sizeof(double) * n, cudaMemcpyDeviceToHost, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaStreamSynchronize(stream);
}

extern "C" int repro_nic_flow_counts(const int64_t* nodes, int64_t n,
                                     unsigned long long* counts,
                                     cudaStream_t stream) {
    if (n == 0) return 0;
    if (n < 0 || reinterpret_cast<uintptr_t>(nodes) % 8) return (int)cudaErrorInvalidValue;
    const int64_t b = (n / 2 + kThreads - 1) / kThreads;
    const int blocks = (int)(b < 1 ? 1 : b < kCountBlocks ? b : kCountBlocks);
    nic_flow_counts_kernel<<<blocks, kThreads, 0, stream>>>(nodes, n, counts);
    return (int)cudaGetLastError();
}
