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
// per-NIC active-flow count, a bincount.  Integer atomics commute, so the
// result is exact and deterministic whatever the order of the adds.  It is
// bound by the atomics on hot NICs, not by the 8 bytes a flow it reads.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks on each SM

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

__global__ void nic_flow_counts_kernel(const int64_t* __restrict__ nodes,
                                       int64_t n,
                                       unsigned long long* __restrict__ counts) {
    const int64_t stride = (int64_t)blockDim.x * gridDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        atomicAdd(&counts[nodes[i]], 1ULL);
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
    nic_flow_counts_kernel<<<blocks_for(n), kThreads, 0, stream>>>(nodes, n,
                                                                  counts);
    return (int)cudaGetLastError();
}
