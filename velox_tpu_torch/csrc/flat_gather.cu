// Flat gather: out[i] = data[idx[i]] for 4- and 8-byte elements.
//
// Replaces B5, _flat_gather_kernel of velox_tpu/ops/pallas_kernels.py (run
// through flat_gather). The TPU kernel holds the data in VMEM as (R, 128)
// lanes and assembles each output lane with 128 lane rotations and a
// take_along_axis, so its data is capped at 2^20 elements and every larger
// gather falls back to XLA. On Hopper a gather is a plain indexed load:
// nothing here caps the data length, and the join probe (exec/join.py)
// sends its domain-table, permutation and column gathers through it.
//
// Bound: device memory. Each output element reads its index and writes
// itself, both coalesced; its data read is random. For data that fits the
// 50 MB L2 the random reads mostly hit L2; for larger data each read costs
// a 32-byte sector of DRAM traffic for 4 or 8 useful bytes. The design
// answers that with memory-level parallelism: a thread loads kUnroll
// indices, then issues kUnroll independent data loads through the
// read-only path (__ldg) before it stores any of them, so many random
// reads are in flight per thread. cp.async/TMA staging and L2 persistence
// of the data are later work.
//
// One template over the element width (4 or 8 bytes, moved as raw bits,
// so any 32- or 64-bit dtype) and the index width (int32 or int64).
// Indices must lie in [0, n_data): the kernel does not check them (the
// wrapper in ops/gather.py documents the contract; the reference's
// callers clip first, as the join does). The kernel allocates nothing,
// launches on the stream it is given, and the entry point returns
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // indices (and data loads in flight) a thread
constexpr int kPerBlock = kThreads * kUnroll;

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
flat_gather_kernel(const T* __restrict__ data, const I* __restrict__ idx,
                   int64_t m, T* __restrict__ out) {
  // element u of a thread is base + u * kThreads: for every u, a warp's
  // 32 lanes touch 32 consecutive indices and outputs
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kPerBlock + threadIdx.x;
  I ix[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = base + static_cast<int64_t>(u) * kThreads;
    ix[u] = i < m ? __ldg(idx + i) : I(0);
  }
  T v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = base + static_cast<int64_t>(u) * kThreads;
    if (i < m) v[u] = __ldg(data + ix[u]);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = base + static_cast<int64_t>(u) * kThreads;
    if (i < m) out[i] = v[u];
  }
}

template <typename T, typename I>
void launch(const void* data, const void* idx, int64_t m, void* out,
            cudaStream_t s) {
  const int64_t blocks = (m + kPerBlock - 1) / kPerBlock;
  flat_gather_kernel<T, I><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(data), static_cast<const I*>(idx), m,
      static_cast<T*>(out));
}

template <typename T>
int launch_idx(int idx_bytes, const void* data, const void* idx, int64_t m,
               void* out, cudaStream_t s) {
  if (idx_bytes == 4) {
    launch<T, int>(data, idx, m, out, s);
  } else if (idx_bytes == 8) {
    launch<T, long long>(data, idx, m, out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (m,) = data (n_data,)[idx (m,)]. elem_bytes: 4 or 8; idx_bytes: 4
// (int32) or 8 (int64); every index in [0, n_data). stream: a
// cudaStream_t. Returns a cudaError_t.
int vt_flat_gather(int elem_bytes, int idx_bytes, const void* data,
                   int64_t n_data, const void* idx, int64_t m, void* out,
                   void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  if (n_data <= 0 || (m + kPerBlock - 1) / kPerBlock > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    return launch_idx<unsigned int>(idx_bytes, data, idx, m, out, s);
  }
  if (elem_bytes == 8) {
    return launch_idx<unsigned long long>(idx_bytes, data, idx, m, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
