// Fused range-filter + sum(a * b) over int32 columns: one pass, exact int64.
//
// Replaces the Pallas kernel velox_tpu/ops/filter_reduce.py::_kernel
// (launched through _run_kernel / filtered_sum_product). It computes the
// same value, not the same way:
//
//   sum over rows with row < *n_active and lo_r <= col_r[row] <= hi_r
//   for every range r, of (int64) a[row] * (int64) b[row].
//
// The TPU kernel splits `a` into 16-bit limbs and keeps per-lane int32
// sums because the TPU's vector unit accumulates in int32. Hopper adds
// int64 natively, so each thread accumulates exact int64 products in a
// register, a warp reduce (__shfl_down_sync) and a shared-memory block
// reduce follow, and one atomicAdd per block adds into the int64 total
// the caller owns: zeroed once, it carries a running sum across calls.
// Integer atomics are exact in any order, so the result equals the plain
// PyTorch version bit for bit.
//
// Bound: device memory. Each active row reads 4 bytes of every range
// column, and a product column outside every range only where all
// ranges pass; a few integer operations a row are far below the card's
// rate. The design:
//
// * Compile-time layout. The wrapper (ops/filter_reduce.py
//   kernel_layout) orders the distinct columns the call reads: the range
//   columns first, each with one [lo, hi] (ranges on one column are
//   intersected), then the product columns outside every range. The
//   kernel is a template over those two counts, NR (0..8) and NP (0..2),
//   so every column pointer and bound sits in a register, each column is
//   read once a row, and a or b that is also a range column (Q6's
//   l_discount) reuses the value the filter loaded. Every layout with
//   1 <= NR + NP <= 8 has an instance.
// * 16-byte loads. A thread takes 4 rows a step as one int4 load per
//   range column, kUnroll steps at once, all issued before the first is
//   used: at least 8 16-byte loads in flight a thread (NR * kUnroll >= 8).
//   The loads stream (__ldcs: evict-first; no row is read twice). A
//   product column outside every range is loaded, again as int4, only
//   for the 4-row groups in which some row passed, all of a step's groups
//   at once.
// * Alignment. When every column has the same address modulo 16 (always
//   so for columns the scan allocates), rows before the first 16-byte
//   boundary and after the last whole group run as scalar rows; columns
//   with different offsets take the scalar loop for every row.
// * A persistent grid: at most resident-blocks-per-SM x SMs blocks walk
//   the groups grid-stride; the SM count comes from the wrapper (cached
//   there once per device), the occupancy is computed once per instance.
//
// n_active stays on the device (a pointer), so the host never waits for a
// batch's row count. The kernel allocates nothing and runs on the stream
// it is given; the C entry point returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 8;
constexpr int kMaxProduct = 2;
constexpr int kThreads = 256;

}  // namespace

extern "C" {

// Passed by value, from the ctypes wrapper to the entry point and from
// there to the kernel. Layout must match ops/filter_reduce.py
// (_FilterSumArgs). cols[0..n_ranges) are the range columns, with bounds
// lo/hi; cols[n_ranges..n_ranges + n_product) the product columns outside
// every range; a and b index cols.
struct FilterSumArgs {
  const int32_t* cols[kMaxCols];
  int32_t lo[kMaxCols];
  int32_t hi[kMaxCols];
  int32_t n_ranges;
  int32_t n_product;
  int32_t a;
  int32_t b;
  int64_t n;  // rows in every column
  int32_t sms;  // the card's SM count
  int32_t pad;
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

__device__ __forceinline__ int lane_of(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// value k of an unrolled register array, for a runtime k: a chain of
// selects (a runtime index into the array would move it to local memory)
template <int N, typename V>
__device__ __forceinline__ V pick(const V (&v)[N], int k) {
  V out = v[0];
#pragma unroll
  for (int c = 1; c < N; ++c) {
    if (k == c) out = v[c];
  }
  return out;
}

template <int NR, int NP>
struct Layout {
  static constexpr int kCols = NR + NP;
  // columns loaded for every group: the range columns, or the product
  // columns when there is no range
  static constexpr int kLoaded = NR > 0 ? NR : NP;
  static constexpr int kUnroll =
      kLoaded >= 4 ? 2 : (8 + kLoaded - 1) / kLoaded;
};

template <int NR, int NP>
__global__ void __launch_bounds__(kThreads)
filter_sum_kernel(FilterSumArgs args, int64_t head,
                  const int32_t* __restrict__ n_active,
                  unsigned long long* __restrict__ out) {
  constexpr int NC = Layout<NR, NP>::kCols;
  constexpr int kLoaded = Layout<NR, NP>::kLoaded;
  constexpr int U = Layout<NR, NP>::kUnroll;
  const int32_t* col[NC];
  int lo[NR > 0 ? NR : 1];
  int hi[NR > 0 ? NR : 1];
#pragma unroll
  for (int c = 0; c < NC; ++c) col[c] = args.cols[c];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    lo[r] = args.lo[r];
    hi[r] = args.hi[r];
  }
  const int ia = args.a;
  const int ib = args.b;
  const int64_t na = static_cast<int64_t>(*n_active);
  const int64_t limit = na < 0 ? 0 : (na < args.n ? na : args.n);
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t acc = 0;

  // scalar rows: before the first 16-byte boundary and after the last
  // whole group (every row when the columns' offsets differ: head < 0)
  const int64_t vbeg = head < 0 ? limit : (head < limit ? head : limit);
  const int64_t groups = (limit - vbeg) >> 2;
  const int64_t vend = vbeg + 4 * groups;
  const int32_t* pa = pick<NC>(col, ia);
  const int32_t* pb = pick<NC>(col, ib);
  auto scalar_row = [&](int64_t row) {
    bool keep = true;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int x = col[r][row];
      keep = keep & (x >= lo[r]) & (x <= hi[r]);
    }
    if (keep) acc += static_cast<int64_t>(pa[row]) * pb[row];
  };
  for (int64_t row = tid; row < vbeg; row += threads) scalar_row(row);
  for (int64_t row = vend + tid; row < limit; row += threads) {
    scalar_row(row);
  }

  // keep bits (one a row of the group) from the range columns' values
  auto keep_bits = [&](const int4 (&v)[NC]) {
    unsigned k = 0xFu;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = lane_of(v[r], j);
        if (x < lo[r] || x > hi[r]) k &= ~(1u << j);
      }
    }
    return k;
  };
  auto group_sum = [&](const int4 (&v)[NC], unsigned k) {
    const int4 a = pick<NC>(v, ia);
    const int4 b = pick<NC>(v, ib);
    int64_t s = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k & (1u << j)) {
        s += static_cast<int64_t>(lane_of(a, j)) * lane_of(b, j);
      }
    }
    return s;
  };

  // vector body: U groups a thread a step, grid-stride
  int64_t g = tid;
  for (; g + (U - 1) * threads < groups; g += U * threads) {
    int4 v[U][NC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t row = vbeg + 4 * (g + u * threads);
#pragma unroll
      for (int c = 0; c < kLoaded; ++c) {
        v[u][c] = __ldcs(reinterpret_cast<const int4*>(col[c] + row));
      }
    }
    unsigned k[U];
#pragma unroll
    for (int u = 0; u < U; ++u) k[u] = keep_bits(v[u]);
    if (NR > 0 && NP > 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t row = vbeg + 4 * (g + u * threads);
#pragma unroll
        for (int p = NR; p < NC; ++p) {
          v[u][p] = k[u] ? __ldcs(reinterpret_cast<const int4*>(col[p] + row))
                         : make_int4(0, 0, 0, 0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc += group_sum(v[u], k[u]);
  }
  for (; g < groups; g += threads) {
    int4 v[NC];
    const int64_t row = vbeg + 4 * g;
#pragma unroll
    for (int c = 0; c < kLoaded; ++c) {
      v[c] = __ldcs(reinterpret_cast<const int4*>(col[c] + row));
    }
    const unsigned k = keep_bits(v);
    if (NR > 0 && NP > 0) {
#pragma unroll
      for (int p = NR; p < NC; ++p) {
        v[p] = k ? __ldcs(reinterpret_cast<const int4*>(col[p] + row))
                 : make_int4(0, 0, 0, 0);
      }
    }
    acc += group_sum(v, k);
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

using Launch = cudaError_t (*)(const FilterSumArgs&, int64_t,
                               const int32_t*, unsigned long long*,
                               cudaStream_t);

template <int NR, int NP>
cudaError_t launch(const FilterSumArgs& args, int64_t head,
                   const int32_t* n_active, unsigned long long* out,
                   cudaStream_t stream) {
  // resident blocks per SM of this instance, computed at its first launch
  static const int per_sm = [] {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, filter_sum_kernel<NR, NP>, kThreads, 0) != cudaSuccess ||
        blocks < 1) {
      blocks = 1;
    }
    return blocks;
  }();
  const int64_t per_block =
      static_cast<int64_t>(kThreads) * 4 * Layout<NR, NP>::kUnroll;
  const int64_t want = (args.n + per_block - 1) / per_block;
  const int64_t cap = static_cast<int64_t>(args.sms) * per_sm;
  int blocks = static_cast<int>(want < cap ? want : cap);
  if (blocks < 1) blocks = 1;
  filter_sum_kernel<NR, NP><<<blocks, kThreads, 0, stream>>>(
      args, head, n_active, out);
  return cudaGetLastError();
}

template <int NR, int NP>
constexpr Launch instance() {
  if constexpr (NR + NP >= 1 && NR + NP <= kMaxCols) {
    return &launch<NR, NP>;
  } else {
    return nullptr;
  }
}

// kLaunch[NR][NP]: the instance of each layout (null where none exists)
constexpr Launch kLaunch[kMaxCols + 1][kMaxProduct + 1] = {
    {instance<0, 0>(), instance<0, 1>(), instance<0, 2>()},
    {instance<1, 0>(), instance<1, 1>(), instance<1, 2>()},
    {instance<2, 0>(), instance<2, 1>(), instance<2, 2>()},
    {instance<3, 0>(), instance<3, 1>(), instance<3, 2>()},
    {instance<4, 0>(), instance<4, 1>(), instance<4, 2>()},
    {instance<5, 0>(), instance<5, 1>(), instance<5, 2>()},
    {instance<6, 0>(), instance<6, 1>(), instance<6, 2>()},
    {instance<7, 0>(), instance<7, 1>(), instance<7, 2>()},
    {instance<8, 0>(), instance<8, 1>(), instance<8, 2>()},
};

}  // namespace

extern "C" {

// out: one int64 on the device that the call adds its sum to (the caller
// zeroes it once and may carry it across calls). n_active: one int32 on
// the device. stream: a cudaStream_t. Returns a cudaError_t.
int vt_filter_sum(FilterSumArgs args, const int32_t* n_active, int64_t* out,
                  void* stream) {
  if (args.n_ranges < 0 || args.n_ranges > kMaxCols || args.n_product < 0 ||
      args.n_product > kMaxProduct || args.sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch fn = kLaunch[args.n_ranges][args.n_product];
  const int n_cols = args.n_ranges + args.n_product;
  if (fn == nullptr || args.a < 0 || args.a >= n_cols || args.b < 0 ||
      args.b >= n_cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (args.n <= 0) return static_cast<int>(cudaSuccess);
  // the scalar head: rows before every column's first 16-byte boundary,
  // or -1 (every row scalar) when the columns' offsets differ
  const uintptr_t off = reinterpret_cast<uintptr_t>(args.cols[0]) & 15u;
  int64_t head = static_cast<int64_t>(((16u - off) & 15u) >> 2);
  for (int c = 1; c < n_cols; ++c) {
    if ((reinterpret_cast<uintptr_t>(args.cols[c]) & 15u) != off) head = -1;
  }
  return static_cast<int>(fn(args, head, n_active,
                             reinterpret_cast<unsigned long long*>(out),
                             static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
