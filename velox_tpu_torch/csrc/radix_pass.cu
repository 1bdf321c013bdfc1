// One 8-bit counting-sort pass: digit histogram and stable destinations.
//
// Replaces three Pallas kernels of velox_tpu/ops/pallas_kernels.py:
//
//   B4 _radix_hist_kernel  -> mode kHist:  per-tile 256-bin histogram
//   B2 _radix_rank_kernel  -> mode kPlace, given each tile's offset within
//                             its digit: the stable rank of every row
//                             among all rows with the same digit
//   B3 _radix_pos_kernel   -> mode kPlace, given that offset plus the
//                             digit's base: the counting-sort destination
//
// The TPU kernels run one grid-free program that walks the rows in order,
// builds a (4096, 256) f32 one-hot per block and prefix-sums it with
// roll-adds, carrying per-digit totals from block to block. Hopper blocks
// run in parallel and in no order, so the pass is split the way a GPU
// counting sort is:
//
//   1. kHist: each block owns a tile of kTile consecutive rows and writes
//      the tile's histogram into column `tile` of an int32 (256, n_tiles)
//      table, digit-major.
//   2. glue, in PyTorch (ops/radix.py), like the reference's XLA glue: one
//      exclusive scan of the flattened digit-major table gives every
//      (digit, tile) its first destination.
//   3. kPlace: each block re-reads its tile and gives every row its
//      stable rank inside the tile, then adds the (digit, tile) entry of
//      the table it is given.
//
// Stable ranks without atomics (shared-memory atomics are unordered, so
// they would give the histogram but not the ranks): warp w of a block owns
// rows [w * kRowsPerWarp, (w + 1) * kRowsPerWarp) of the tile and walks
// them 32 at a time. __match_any_sync finds the lanes holding the same
// digit; a row's rank among them is the popcount of the lower lanes, and
// the lowest of them adds the group's size to the warp's private
// histogram in shared memory. After a __syncthreads, thread d turns the
// eight warp histograms of digit d into exclusive offsets in warp order,
// starting from the table's entry, and a last sweep writes
// offset[warp][digit] + rank for every row (digits and ranks wait in
// shared memory, so each row is read from device memory once per launch).
//
// Rows at or past n do not exist for the kernel: the reference pads with
// digit 255, which sorts after every real row and so moves none of them.
//
// Bound: device memory. kHist reads 4 bytes a row, kPlace reads 4 and
// writes 4; the work per row is a handful of integer and shared-memory
// operations. The kernels allocate nothing, launch on the stream they are
// given, and each entry point returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRadix = 256;
constexpr int kThreads = 256;  // one thread per digit in the offset step
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 1024;  // ranks fit uint16_t
constexpr int kTile = kWarps * kRowsPerWarp;
constexpr int kSteps = kRowsPerWarp / 32;
constexpr int kHist = 0;
constexpr int kPlace = 1;

static_assert(kThreads == kRadix, "the offset step maps a thread to a digit");

// Warp `warp` walks its rows of the tile; hist[warp][d] ends as the number
// of its rows with digit d. With kRecord, dig/rank receive each row's
// digit and its rank among the warp's earlier rows of that digit.
template <bool kRecord>
__device__ __forceinline__ void warp_count(
    const int32_t* __restrict__ digits, int64_t n, int64_t tile_start,
    int (*hist)[kRadix], uint8_t* dig, uint16_t* rank) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  int* h = hist[warp];
  for (int step = 0; step < kSteps; ++step) {
    const int first = warp * kRowsPerWarp + step * 32;
    if (tile_start + first >= n) break;  // uniform across the warp
    const int local = first + lane;
    const int64_t row = tile_start + local;
    const bool valid = row < n;
    // the mask only keeps a bad digit inside the table; callers pass
    // digits in [0, 256)
    const int d = valid ? (digits[row] & (kRadix - 1)) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = __popc(peers & lower);
    const int seen = valid ? h[d] : 0;
    __syncwarp();
    if (valid && before == 0) h[d] = seen + __popc(peers);
    __syncwarp();
    if (kRecord && valid) {
      dig[local] = static_cast<uint8_t>(d);
      rank[local] = static_cast<uint16_t>(seen + before);
    }
  }
}

__device__ __forceinline__ void zero_hist(int (*hist)[kRadix]) {
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads) {
    hist[i / kRadix][i % kRadix] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const int32_t* __restrict__ digits, int64_t n,
                  int32_t* __restrict__ table) {
  __shared__ int hist[kWarps][kRadix];
  zero_hist(hist);
  __syncthreads();
  const int64_t tile_start = static_cast<int64_t>(blockIdx.x) * kTile;
  warp_count<false>(digits, n, tile_start, hist, nullptr, nullptr);
  __syncthreads();
  const int d = threadIdx.x;
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += hist[w][d];
  table[static_cast<int64_t>(d) * gridDim.x + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
radix_place_kernel(const int32_t* __restrict__ digits, int64_t n,
                   const int32_t* __restrict__ table,
                   int32_t* __restrict__ out) {
  __shared__ int hist[kWarps][kRadix];
  __shared__ uint8_t dig[kTile];
  __shared__ uint16_t rank[kTile];
  zero_hist(hist);
  __syncthreads();
  const int64_t tile_start = static_cast<int64_t>(blockIdx.x) * kTile;
  warp_count<true>(digits, n, tile_start, hist, dig, rank);
  __syncthreads();
  // warp histograms -> exclusive offsets in warp order, from the table
  const int d = threadIdx.x;
  int acc = table[static_cast<int64_t>(d) * gridDim.x + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = hist[w][d];
    hist[w][d] = acc;
    acc += c;
  }
  __syncthreads();
  for (int local = threadIdx.x; local < kTile; local += kThreads) {
    const int64_t row = tile_start + local;
    if (row >= n) break;
    out[row] = hist[local / kRowsPerWarp][dig[local]] + rank[local];
  }
}

}  // namespace

extern "C" {

// Rows per tile: the wrapper sizes the (256, n_tiles) table with it.
int vt_radix_tile_rows() { return kTile; }

// mode kHist: table (256, n_tiles) int32 is written; out is unused.
// mode kPlace: table is read; out (n,) int32 is written.
// digits: (n,) int32 in [0, 256), n < 2^31. stream: a cudaStream_t.
// Returns a cudaError_t.
int vt_radix_pass(int mode, const int32_t* digits, int64_t n,
                  int32_t* table, int32_t* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int64_t tiles = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kHist) {
    radix_hist_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
        digits, n, table);
  } else if (mode == kPlace) {
    radix_place_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
        digits, n, table, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
