// Flat gather: out[c][i] = data[c][idx[i]] for up to 8 columns of 4- and
// 8-byte elements through one int32 or int64 index.
//
// Replaces B5, _flat_gather_kernel of velox_tpu/ops/pallas_kernels.py (run
// through flat_gather). The TPU kernel holds the data in VMEM as (R, 128)
// lanes and assembles each output lane with 128 lane rotations and a
// take_along_axis, so its data is capped at 2^20 elements and every larger
// gather falls back to XLA. On Hopper a gather is a plain indexed load:
// nothing here caps the data length. The join probe (exec/join.py) sends
// its domain-table lookups and its build and probe columns through it,
// the sort (exec/sort.py) its sort-word gathers.
//
// Bound: device memory. Each output row reads its index and writes itself,
// both streams read or written once; its data read is random: a 32-byte
// sector of device memory for 4 or 8 useful bytes, unless the sector is
// in L2 (the bound in chip_smoke.py counts each distinct sector once). The
// design, each part chosen by a sweep on an H100 (PERF.md):
//
// * One tile a block, in the hardware scheduler's order. A block takes
//   kThreads * kRows consecutive index rows; the blocks resident at any
//   time cover one contiguous window of the index, so a sorted or
//   half-sorted index (the full sort's permutation) reads a narrow window
//   of the data. Persistent blocks lost: walking tiles grid-stride lets
//   the blocks drift apart over a 60M-row index, and one equal share per
//   block scatters the window outright.
// * kRows data loads in flight a thread. A thread owns kRows / 4 groups
//   of 4 consecutive rows: it loads their indices as 16-byte loads, then
//   issues all kRows random loads of a column before it stores any, then
//   stores each group as 16 bytes (4 int32, or 2 x 2 int64). 8 rows (64
//   registers, 4 blocks a SM) tied 4 and beat 16 (one block a SM).
// * L2 policy. The index loads and the output stores carry evict-first,
//   so the streams read or written once leave L2 to the data. The data
//   loads carry none: an evict-last policy on them cost 3% at uniform
//   indices into a 240 MB table and 12% on three columns at once.
//   Bringing the index tile in by one cp.async.bulk on an mbarrier tied
//   the 16-byte loads, so the simpler form stayed.
// * Columns through one index. vt_flat_gather_multi gathers up to 8
//   columns of mixed widths in one launch: each tile's indices are loaded
//   once and serve every column in turn. vt_flat_gather is its
//   one-column form by scalar arguments.
//
// Indices must lie in [0, n_data): the kernel does not check them (the
// wrapper in ops/gather.py documents the contract; the callers clip
// first, as the join does). Outputs must start on a 16-byte boundary
// (the wrapper allocates them). The kernel allocates nothing, launches on
// the stream it is given, and the entry point returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // index rows a thread
constexpr int kTile = kThreads * kRows;
constexpr int kMaxCols = 8;

}  // namespace

extern "C" {

// Passed by value to vt_flat_gather_multi and on to the kernel. Layout must
// match ops/gather.py (_GatherArgs).
struct GatherArgs {
  const void* data[kMaxCols];
  void* out[kMaxCols];
  int32_t elem_bytes[kMaxCols];  // 4 or 8
  int32_t n_cols;
  int32_t idx_bytes;  // 4 (int32) or 8 (int64)
  const void* idx;
  int64_t m;  // index rows
};

}  // extern "C"

namespace {

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint32_t load_data(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint64_t load_data(const uint64_t* p) {
  uint64_t v;
  asm("ld.global.nc.b64 %0, [%1];\n" : "=l"(v) : "l"(p));
  return v;
}

// four consecutive indices from a 16-byte aligned address
__device__ __forceinline__ void load4_hint(const int32_t* p, uint64_t pol,
                                           int32_t (&out)[4]) {
  asm("ld.global.nc.L2::cache_hint.v4.b32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(out[0]), "=r"(out[1]), "=r"(out[2]), "=r"(out[3])
      : "l"(p), "l"(pol));
}

__device__ __forceinline__ void load4_hint(const long long* p, uint64_t pol,
                                           long long (&out)[4]) {
  asm("ld.global.nc.L2::cache_hint.v2.b64 {%0, %1}, [%2], %3;\n"
      : "=l"(out[0]), "=l"(out[1])
      : "l"(p), "l"(pol));
  asm("ld.global.nc.L2::cache_hint.v2.b64 {%0, %1}, [%2], %3;\n"
      : "=l"(out[2]), "=l"(out[3])
      : "l"(p + 2), "l"(pol));
}

// four consecutive outputs to a 16-byte aligned address
__device__ __forceinline__ void store4_hint(uint32_t* p, const uint32_t* v,
                                            uint64_t pol) {
  asm volatile(
      "st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(
          p),
      "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void store4_hint(uint64_t* p, const uint64_t* v,
                                            uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v2.b64 [%0], {%1, %2}, %3;\n" ::"l"(
                   p),
               "l"(v[0]), "l"(v[1]), "l"(pol)
               : "memory");
  asm volatile("st.global.L2::cache_hint.v2.b64 [%0], {%1, %2}, %3;\n" ::"l"(
                   p + 2),
               "l"(v[2]), "l"(v[3]), "l"(pol)
               : "memory");
}

// Gathers one column at the thread's kRows indices of the tile and stores
// them; `rows` is the tile's row count (kTile unless it is the last tile).
template <typename T, typename I>
__device__ __forceinline__ void gather_column(const void* data_v, void* out_v,
                                              const I (&ix)[kRows],
                                              int64_t tile_start, int rows,
                                              uint64_t stream) {
  const T* __restrict__ data = static_cast<const T*>(data_v);
  T* __restrict__ out = static_cast<T*>(out_v) + tile_start;
  const bool full = rows == kTile;
  T v[kRows];
#pragma unroll
  for (int g = 0; g < kRows / 4; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pos = (g * kThreads + static_cast<int>(threadIdx.x)) * 4 + j;
      if (full || pos < rows) v[g * 4 + j] = load_data(data + ix[g * 4 + j]);
    }
  }
#pragma unroll
  for (int g = 0; g < kRows / 4; ++g) {
    const int pos = (g * kThreads + static_cast<int>(threadIdx.x)) * 4;
    if (full || pos + 3 < rows) {
      store4_hint(out + pos, v + g * 4, stream);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (pos + j < rows) out[pos + j] = v[g * 4 + j];
      }
    }
  }
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
flat_gather_kernel(const __grid_constant__ GatherArgs args) {
  const I* __restrict__ idx = static_cast<const I*>(args.idx);
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int rows =
      static_cast<int>(args.m - start < kTile ? args.m - start : kTile);
  const uint64_t stream = policy_evict_first();
  // 16-byte index loads need a 16-byte aligned index (a view may start
  // off the boundary: then one index at a time)
  const bool aligned = (reinterpret_cast<uintptr_t>(idx) & 15u) == 0;
  I ix[kRows];
#pragma unroll
  for (int g = 0; g < kRows / 4; ++g) {
    const int pos = (g * kThreads + static_cast<int>(threadIdx.x)) * 4;
    if (aligned && pos + 3 < rows) {
      I four[4];
      load4_hint(idx + start + pos, stream, four);
#pragma unroll
      for (int j = 0; j < 4; ++j) ix[g * 4 + j] = four[j];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ix[g * 4 + j] = pos + j < rows ? idx[start + pos + j] : I(0);
      }
    }
  }
  for (int c = 0; c < args.n_cols; ++c) {
    if (args.elem_bytes[c] == 4) {
      gather_column<uint32_t, I>(args.data[c], args.out[c], ix, start, rows,
                                 stream);
    } else {
      gather_column<uint64_t, I>(args.data[c], args.out[c], ix, start, rows,
                                 stream);
    }
  }
}

}  // namespace

extern "C" {

// Columns c < n_cols: out[c] (m,) = data[c][idx (m,)], elem_bytes[c] 4 or
// 8; idx_bytes 4 (int32) or 8 (int64); every index in [0, len(data[c])),
// every out[c] on a 16-byte boundary. stream: a cudaStream_t. Returns a
// cudaError_t.
int vt_flat_gather_multi(GatherArgs args, void* stream) {
  if (args.m <= 0) return static_cast<int>(cudaSuccess);
  const int64_t tiles = (args.m + kTile - 1) / kTile;
  if (args.n_cols < 1 || args.n_cols > kMaxCols || tiles > 0x7fffffffLL ||
      (args.idx_bytes != 4 && args.idx_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int c = 0; c < args.n_cols; ++c) {
    if ((args.elem_bytes[c] != 4 && args.elem_bytes[c] != 8) ||
        (reinterpret_cast<uintptr_t>(args.out[c]) & 15u) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(tiles);
  if (args.idx_bytes == 4) {
    flat_gather_kernel<int32_t><<<blocks, kThreads, 0, s>>>(args);
  } else {
    flat_gather_kernel<long long><<<blocks, kThreads, 0, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

// One column, by scalar arguments (the single-column callers' entry: no
// argument struct to fill on the host): out (m,) = data[idx (m,)].
int vt_flat_gather(int elem_bytes, int idx_bytes, const void* data,
                   const void* idx, int64_t m, void* out, void* stream) {
  GatherArgs args = {};
  args.data[0] = data;
  args.out[0] = out;
  args.elem_bytes[0] = elem_bytes;
  args.n_cols = 1;
  args.idx_bytes = idx_bytes;
  args.idx = idx;
  args.m = m;
  return vt_flat_gather_multi(args, stream);
}

}  // extern "C"
