// Fused range-filter + sum(a * b) over int32 columns: one pass, exact int64.
//
// Replaces the Pallas kernel velox_tpu/ops/filter_reduce.py::_kernel
// (launched through _run_kernel / filtered_sum_product). It computes the
// same value, not the same way:
//
//   sum over rows with row < *n_active and lo_r <= cols[c_r][row] <= hi_r
//   for every range r, of (int64) cols[a][row] * (int64) cols[b][row].
//
// The TPU kernel splits `a` into 16-bit limbs and keeps per-lane int32
// sums because the TPU's vector unit accumulates in int32. Hopper adds
// int64 natively, so each thread accumulates exact int64 products in a
// register, a warp reduce (__shfl_down_sync) and a shared-memory block
// reduce follow, and one atomicAdd per block adds into the int64 output,
// which the caller zeroed. Integer atomics are exact in any order, so the
// result equals the plain PyTorch version bit for bit.
//
// Bound: device memory. Each row reads 4 bytes per distinct column and
// does a few integer operations, so the kernel cannot beat
// (4 * n_cols * n) bytes / memory bandwidth. This first version uses one
// grid-stride loop of plain coalesced 4-byte loads; 16-byte vector loads
// and persistent blocks are later work.
//
// n_active stays on the device (a pointer), so the host never waits for a
// batch's row count. The kernel allocates nothing and runs on the stream
// it is given; the C entry point returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 8;
constexpr int kMaxRanges = 8;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

}  // namespace

extern "C" {

// Passed by value, from the ctypes wrapper to the entry point and from
// there to the kernel. Layout must match ops/filter_reduce.py
// (_FilterSumArgs).
struct FilterSumArgs {
  const int32_t* cols[kMaxCols];
  int64_t lo[kMaxRanges];
  int64_t hi[kMaxRanges];
  int32_t range_col[kMaxRanges];
  int32_t n_ranges;
  int32_t a_col;
  int32_t b_col;
  int32_t pad;
  int64_t n;  // rows in every column
};

}  // extern "C"

namespace {

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, static_cast<long long>(v), off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
filter_sum_kernel(FilterSumArgs args, const int32_t* __restrict__ n_active,
                  unsigned long long* __restrict__ out) {
  const int64_t na = static_cast<int64_t>(*n_active);
  const int64_t limit = na < args.n ? na : args.n;
  const int32_t* __restrict__ a = args.cols[args.a_col];
  const int32_t* __restrict__ b = args.cols[args.b_col];
  int64_t acc = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       row < limit; row += stride) {
    bool keep = true;
#pragma unroll
    for (int r = 0; r < kMaxRanges; ++r) {
      if (r < args.n_ranges) {
        const int64_t x = args.cols[args.range_col[r]][row];
        keep = keep & (x >= args.lo[r]) & (x <= args.hi[r]);
      }
    }
    if (keep) {
      acc += static_cast<int64_t>(a[row]) * static_cast<int64_t>(b[row]);
    }
  }

  __shared__ int64_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < (kThreads / 32) ? warp_sums[lane] : 0;
    acc = warp_sum(acc);
    if (lane == 0 && acc != 0) {
      // two's-complement wrap makes the unsigned add an exact int64 add
      atomicAdd(out, static_cast<unsigned long long>(acc));
    }
  }
}

}  // namespace

extern "C" {

// out: one int64 on the device, zeroed by the caller. n_active: one int32
// on the device. stream: a cudaStream_t. Returns a cudaError_t.
int vt_filter_sum(FilterSumArgs args, const int32_t* n_active, int64_t* out,
                  void* stream) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t want = (args.n + kThreads - 1) / kThreads;
  int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  int blocks = static_cast<int>(want < cap ? want : cap);
  if (blocks < 1) blocks = 1;
  filter_sum_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      args, n_active, reinterpret_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
