// One 8-bit counting-sort pass on Hopper: digit histogram, stable ranks,
// and destinations or the scattered next sort state.
//
// Replaces three Pallas kernels of velox_tpu/ops/pallas_kernels.py:
//
//   B4 _radix_hist_kernel (:85, pallas_call :106) -> radix_hist_kernel<T>
//   B2 _radix_rank_kernel (:45)                   -> radix_rank_kernel
//   B3 _radix_pos_kernel  (:116, pallas_call :158) -> radix_place_kernel
//      with the positions epilogue, and the scatter epilogue that also
//      moves the sort state
//
// The TPU kernels run one grid-free program that walks the rows in order,
// builds a (4096, 256) f32 one-hot per block and prefix-sums it with
// roll-adds, carrying per-digit totals from block to block. Hopper blocks
// run in parallel and in no order, so the pass is split the way a GPU
// counting sort is. Every kernel gives one block a tile of kTile
// consecutive rows:
//
//   1. radix_hist_kernel writes the tile's digit counts into column `tile`
//      of an int32 (256, n_tiles) table, digit-major.
//   2. glue, in PyTorch (ops/radix.py): one exclusive scan of the
//      flattened table gives every (digit, tile) its first destination
//      (or, scanned per digit, its offset within the digit, for B2).
//   3. radix_place_kernel (B3) or radix_rank_kernel (B2) gives every row
//      its stable rank among the tile's rows of its digit and adds the
//      table entry of (digit, tile).
//
// A digit comes either from an int32 digit array (the classic loop and
// the reference's whole-pass functions) or from the int64 sort state of
// the scatter branch, whose digit is its low `bits` bits: the kernel takes
// it there, so the scatter branch has no row-sized digit tensor. The
// scatter epilogue writes the state's remaining bits, (uint64)state >>
// bits, to the row's destination, so one pass of that branch is two
// launches (histogram, place-and-scatter) and the 256 x n_tiles scan.
//
// What bounds them: device memory. Per row, the histogram reads 8 bytes
// of state (4 of digits); place-and-scatter reads 8 and writes 8;
// positions read 4 and write 4; plus the table. The design follows:
//
// * radix_hist_kernel: each of 512 threads loads its 16 rows of the tile
//   with 16-byte loads, all issued before the first is used (the digits
//   wait four to a register), and counts them with shared-memory atomics
//   into its warp's own histogram (a histogram is order-free: no ranks).
//   A thread adds a run of equal digits once, so a tile of one digit (32
//   lanes on one address) costs one atomic a thread, not one a row.
// * radix_place_kernel: one block of 512 threads takes the whole tile into
//   shared memory first (64 KB of state: dynamic shared memory), by one
//   cp.async.bulk copy completed on an mbarrier (on an H100 80GB HBM3 at
//   700 W it beat 16-byte vector loads of the same tile by 1-6% in each
//   of eight timed cells: scatter and positions, 6.7M and 60M rows,
//   uniform and one-digit tiles). Then warp w ranks rows
//   [512 w, 512 w + 512) in 16 steps of 32 rows: the lanes holding the same digit are found by a multi-split over the
//   digit's bits (one __ballot_sync per bit, as CUB's block radix rank
//   does), a row's rank among them is the popcount of the lower lanes,
//   and the lowest of them adds the group's size to the warp's counter of
//   that digit. The steps of a warp depend on each other only through
//   that counter in shared memory; no load from device memory sits inside
//   the chain (B2's form loads a digit in every step, which leaves few
//   loads in flight: its time is latency, not bytes, see PERF.md), and
//   the 32 warps of two resident blocks hide the rest. Warp counters
//   become offsets in warp order and a 256-digit scan gives each digit's
//   first slot in the tile.
//   - positions epilogue: out[row] = table[d, tile] + rank in tile, with
//     each warp storing 32 consecutive rows.
//   - scatter epilogue: every row's slot in the tile (digit order, stable)
//     receives its row number in shared memory; then thread t walks slots
//     t, t + 512, ... and writes the slot's shifted state to
//     table[d, tile] + (slot - first slot of d): neighbouring threads
//     store to neighbouring addresses inside each digit's run.
//   Tried on the H100 and slower: __match_any_sync instead of the ballots
//   (faster only on one-digit tiles), two interleaved rank chains a warp,
//   a third resident block, and one persistent 1024-thread block per SM
//   that copies the next tile while it ranks the current one: the rank
//   and write phases, not the loads, set the time of a tile.
// * radix_rank_kernel (B2) keeps its first form: 8 warps of 1024 rows,
//   __match_any_sync ranks, digits read inside the rank loop.
//
// Rows at or past n do not exist for the kernels: the reference pads with
// digit 255, which sorts after every real row and so moves none of them.
// The kernels allocate nothing, launch on the stream they are given, and
// each entry point returns a cudaError_t.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRadix = 256;
constexpr int kTile = 8192;  // rows per tile: one column of the table
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int tile_rows(int64_t n, int64_t tile_start) {
  const int64_t left = n - tile_start;
  return left < kTile ? static_cast<int>(left) : kTile;
}

template <typename T>
__device__ __forceinline__ unsigned digit_of(T v, unsigned mask) {
  return static_cast<unsigned>(v) & mask;
}

// 16 bytes of a source array as one load.
template <typename T>
struct Vec16;
template <>
struct Vec16<int32_t> {
  using type = int4;
  static constexpr int kRows = 4;
  __device__ static int32_t row(const int4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};
template <>
struct Vec16<int64_t> {
  using type = longlong2;
  static constexpr int kRows = 2;
  __device__ static int64_t row(const longlong2& v, int j) {
    return j == 0 ? v.x : v.y;
  }
};

// ---------------------------------------------------------------------------
// B4: the histogram
// ---------------------------------------------------------------------------

constexpr int kHistThreads = 512;
constexpr int kHistWarps = kHistThreads / 32;
static_assert(kHistThreads >= kRadix, "the last step maps a thread to a digit");

// Counts a thread's rows into its warp's histogram, one atomic per run of
// equal digits.
struct RunCounter {
  int* hist;
  unsigned digit;
  int count;
  __device__ void add(unsigned d) {
    if (d == digit) {
      ++count;
      return;
    }
    if (count) atomicAdd(&hist[digit], count);
    digit = d;
    count = 1;
  }
  __device__ void flush() {
    if (count) atomicAdd(&hist[digit], count);
  }
};

template <typename T>
__global__ void __launch_bounds__(kHistThreads)
radix_hist_kernel(const T* __restrict__ src, int64_t n, unsigned mask,
                  int32_t* __restrict__ table) {
  using V = Vec16<T>;
  constexpr int kLoads = kTile / V::kRows / kHistThreads;
  __shared__ int hist[kHistWarps][kRadix];
  for (int i = threadIdx.x; i < kHistWarps * kRadix; i += kHistThreads) {
    hist[i / kRadix][i % kRadix] = 0;
  }
  __syncthreads();
  const int64_t tile_start = static_cast<int64_t>(blockIdx.x) * kTile;
  const T* tile = src + tile_start;
  const int rows = tile_rows(n, tile_start);
  RunCounter run{hist[threadIdx.x >> 5], static_cast<unsigned>(kRadix), 0};
  if (rows == kTile) {
    // every digit of the thread's rows, four to a register, before the
    // first atomic: the compiler keeps all the loads in flight
    constexpr int kRowsPerThread = kTile / kHistThreads;
    const auto* vec = reinterpret_cast<const typename V::type*>(tile);
    uint32_t packed[kRowsPerThread / 4] = {};
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const typename V::type v = __ldg(vec + i * kHistThreads + threadIdx.x);
#pragma unroll
      for (int j = 0; j < V::kRows; ++j) {
        const int k = i * V::kRows + j;
        packed[k / 4] |= digit_of(V::row(v, j), mask) << (8 * (k % 4));
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      run.add((packed[k / 4] >> (8 * (k % 4))) & 0xffu);
    }
  } else {
    for (int r = threadIdx.x; r < rows; r += kHistThreads) {
      run.add(digit_of(tile[r], mask));
    }
  }
  run.flush();
  __syncthreads();
  const int d = threadIdx.x;
  if (d < kRadix) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kHistWarps; ++w) total += hist[w][d];
    table[static_cast<int64_t>(d) * gridDim.x + blockIdx.x] = total;
  }
}

// ---------------------------------------------------------------------------
// B2: ranks within the digit (first form)
// ---------------------------------------------------------------------------

constexpr int kRankThreads = 256;  // one thread per digit in the offset step
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kRowsPerWarp = kTile / kRankWarps;  // ranks fit uint16_t
constexpr int kRankSteps = kRowsPerWarp / 32;
static_assert(kRankThreads == kRadix, "the offset step maps a thread to a digit");

__global__ void __launch_bounds__(kRankThreads)
radix_rank_kernel(const int32_t* __restrict__ digits, int64_t n,
                  const int32_t* __restrict__ table,
                  int32_t* __restrict__ out) {
  __shared__ int hist[kRankWarps][kRadix];
  __shared__ uint8_t dig[kTile];
  __shared__ uint16_t rank[kTile];
  for (int i = threadIdx.x; i < kRankWarps * kRadix; i += kRankThreads) {
    hist[i / kRadix][i % kRadix] = 0;
  }
  __syncthreads();
  const int64_t tile_start = static_cast<int64_t>(blockIdx.x) * kTile;
  // warp `warp` walks its rows; hist[warp][d] ends as the number of its
  // rows with digit d, dig/rank receive each row's digit and its rank
  // among the warp's earlier rows of that digit
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  int* h = hist[warp];
  for (int step = 0; step < kRankSteps; ++step) {
    const int first = warp * kRowsPerWarp + step * 32;
    if (tile_start + first >= n) break;  // uniform across the warp
    const int local = first + lane;
    const int64_t row = tile_start + local;
    const bool valid = row < n;
    // the mask only keeps a bad digit inside the table; callers pass
    // digits in [0, 256)
    const int d = valid ? (digits[row] & (kRadix - 1)) : kRadix;
    const unsigned peers = __match_any_sync(kFull, d);
    const int before = __popc(peers & lower);
    const int seen = valid ? h[d] : 0;
    __syncwarp();
    if (valid && before == 0) h[d] = seen + __popc(peers);
    __syncwarp();
    if (valid) {
      dig[local] = static_cast<uint8_t>(d);
      rank[local] = static_cast<uint16_t>(seen + before);
    }
  }
  __syncthreads();
  // warp histograms -> exclusive offsets in warp order, from the table
  const int d = threadIdx.x;
  int acc = table[static_cast<int64_t>(d) * gridDim.x + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kRankWarps; ++w) {
    const int c = hist[w][d];
    hist[w][d] = acc;
    acc += c;
  }
  __syncthreads();
  for (int local = threadIdx.x; local < kTile; local += kRankThreads) {
    const int64_t row = tile_start + local;
    if (row >= n) break;
    out[row] = hist[local / kRowsPerWarp][dig[local]] + rank[local];
  }
}

// ---------------------------------------------------------------------------
// B3: place (positions or scatter)
// ---------------------------------------------------------------------------

constexpr int kPlaceThreads = 512;
constexpr int kPlaceWarps = kPlaceThreads / 32;
constexpr int kPlaceWarpRows = kTile / kPlaceWarps;
constexpr int kPlaceSteps = kPlaceWarpRows / 32;  // rows a lane ranks
constexpr int kPositions = 0;
constexpr int kScatter = 1;
static_assert(kPlaceThreads >= kRadix, "the scan maps a thread to a digit");

template <typename T, int kEpilogue>
struct PlaceSmem {
  T src[kTile];  // the tile's digits or state
  // slot -> row of the tile (the scatter epilogue only)
  uint16_t slot_row[kEpilogue == kScatter ? kTile : 1];
  // each warp's count of every digit, then its offset within the tile's
  // rows of that digit
  uint16_t warp_off[kPlaceWarps][kRadix];
  int start[kRadix];  // the tile's first slot of each digit
  int base[kRadix];   // table[d, tile]
  int scan[kRadix / 32];
  unsigned long long bar;  // the bulk copy's mbarrier
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Brings the tile's `rows` rows into s.src, visible to every thread on
// return: one thread copies the 16-byte multiple by cp.async.bulk; plain
// loads take the at most 3 int32 or 1 int64 past it.
template <typename T, int kEpilogue>
__device__ __forceinline__ void load_tile(PlaceSmem<T, kEpilogue>& s,
                                          const T* tile, int rows) {
  const int tid = threadIdx.x;
  const int bulk = (rows * static_cast<int>(sizeof(T))) & ~15;
  const uint32_t bar = smem_addr(&s.bar);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (bulk > 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(bulk)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(s.src)),
          "l"(tile), "r"(bulk), "r"(bar)
          : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                   : "memory");
    }
  }
  for (int r = bulk / static_cast<int>(sizeof(T)) + tid; r < rows;
       r += kPlaceThreads) {
    s.src[r] = tile[r];
  }
  __syncthreads();  // the barrier is initialised, the tail stored
  mbar_wait(bar, 0);
}

// bits: the digit's width (8 for int32 digits). kPositions: out is (n,)
// int32, table[d, tile] + the row's stable rank among the tile's rows of
// digit d. kScatter: out is (n,) int64; the row's (uint64)state >> bits
// goes to that position.
template <typename T, int kEpilogue>
__global__ void __launch_bounds__(kPlaceThreads, 2)
radix_place_kernel(const T* __restrict__ src, int64_t n, int bits,
                   const int32_t* __restrict__ table, void* __restrict__ out) {
  static_assert(kEpilogue == kPositions || sizeof(T) == 8,
                "the scatter epilogue moves the int64 sort state");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto& s = *reinterpret_cast<PlaceSmem<T, kEpilogue>*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile_start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int rows = tile_rows(n, tile_start);
  for (int i = tid; i < kPlaceWarps * kRadix; i += kPlaceThreads) {
    s.warp_off[i / kRadix][i % kRadix] = 0;
  }
  if (tid < kRadix) {
    s.base[tid] = table[static_cast<int64_t>(tid) * gridDim.x + blockIdx.x];
  }
  load_tile<T, kEpilogue>(s, src + tile_start, rows);

  // rank: (rank among the warp's rows of the digit) | digit << 16 per step
  const unsigned mask = (1u << bits) - 1u;
  const unsigned lower = (1u << lane) - 1u;
  const int warp_first = warp * kPlaceWarpRows;
  uint16_t* count = s.warp_off[warp];
  uint32_t ranked[kPlaceSteps];
#pragma unroll
  for (int step = 0; step < kPlaceSteps; ++step) {
    const int r = warp_first + step * 32 + lane;
    const bool valid = r < rows;
    const unsigned d = valid ? digit_of(s.src[r], mask) : 0u;
    unsigned peers = __ballot_sync(kFull, valid);
    for (int b = 0; b < bits; ++b) {
      const unsigned set = __ballot_sync(kFull, (d >> b) & 1u);
      peers &= ((d >> b) & 1u) ? set : ~set;
    }
    const int before = __popc(peers & lower);
    int seen = 0;
    if (valid && before == 0) {
      seen = count[d];
      count[d] = static_cast<uint16_t>(seen + __popc(peers));
    }
    seen = __shfl_sync(kFull, seen, valid ? __ffs(peers) - 1 : lane);
    __syncwarp();  // the next step's lowest lane reads this one's count
    ranked[step] = static_cast<uint32_t>(seen + before) | (d << 16);
  }
  __syncthreads();

  // warp counts -> offsets in warp order; digit totals -> first slots
  int total = 0;
  int incl = 0;
  if (tid < kRadix) {
#pragma unroll
    for (int w = 0; w < kPlaceWarps; ++w) {
      const int c = s.warp_off[w][tid];
      s.warp_off[w][tid] = static_cast<uint16_t>(total);
      total += c;
    }
    incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s.scan[warp] = incl;
  }
  __syncthreads();
  if (tid < kRadix) {
    int before = 0;
    for (int w = 0; w < warp; ++w) before += s.scan[w];
    s.start[tid] = before + incl - total;
  }
  __syncthreads();

  if constexpr (kEpilogue == kPositions) {
    int32_t* pos = static_cast<int32_t*>(out) + tile_start;
#pragma unroll
    for (int step = 0; step < kPlaceSteps; ++step) {
      const int r = warp_first + step * 32 + lane;
      if (r < rows) {
        const unsigned d = ranked[step] >> 16;
        pos[r] = s.base[d] + s.warp_off[warp][d] +
                 static_cast<int>(ranked[step] & 0xffffu);
      }
    }
  } else {
#pragma unroll
    for (int step = 0; step < kPlaceSteps; ++step) {
      const int r = warp_first + step * 32 + lane;
      if (r < rows) {
        const unsigned d = ranked[step] >> 16;
        s.slot_row[s.start[d] + s.warp_off[warp][d] +
                   static_cast<int>(ranked[step] & 0xffffu)] =
            static_cast<uint16_t>(r);
      }
    }
    __syncthreads();
    uint64_t* next = static_cast<uint64_t*>(out);
    for (int slot = tid; slot < rows; slot += kPlaceThreads) {
      const uint64_t v = static_cast<uint64_t>(s.src[s.slot_row[slot]]);
      const unsigned d = static_cast<unsigned>(v) & mask;
      next[static_cast<int64_t>(s.base[d]) + (slot - s.start[d])] = v >> bits;
    }
  }
}

// Lets one B3 kernel take its shared memory, once per device.
template <typename T, int kEpilogue>
cudaError_t place_setup() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      radix_place_kernel<T, kEpilogue>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(PlaceSmem<T, kEpilogue>)));
  ready[dev] = err == cudaSuccess;
  return err;
}

template <typename T, int kEpilogue>
cudaError_t place(const T* src, int bits, int64_t n, const int32_t* table,
                  void* out, cudaStream_t stream) {
  const cudaError_t err = place_setup<T, kEpilogue>();
  if (err != cudaSuccess) return err;
  const unsigned tiles = static_cast<unsigned>((n + kTile - 1) / kTile);
  radix_place_kernel<T, kEpilogue>
      <<<tiles, kPlaceThreads, sizeof(PlaceSmem<T, kEpilogue>), stream>>>(
          src, n, bits, table, out);
  return cudaGetLastError();
}

template <typename T, int kEpilogue>
cudaError_t place_occupancy(int* blocks, int* smem) {
  *smem = static_cast<int>(sizeof(PlaceSmem<T, kEpilogue>));
  const cudaError_t err = place_setup<T, kEpilogue>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, radix_place_kernel<T, kEpilogue>, kPlaceThreads, *smem);
}

}  // namespace

extern "C" {

// Rows per tile: the wrapper sizes the (256, n_tiles) table with it.
int vt_radix_tile_rows() { return kTile; }

// B4. src: (n,) int32 digits (src_bytes 4, bits 8) or the int64 sort state
// (src_bytes 8), whose digit is its low `bits` bits (1..8). table: (256,
// n_tiles) int32, written. n < 2^31; src 16-byte aligned.
int vt_radix_hist(const void* src, int src_bytes, int bits, int64_t n,
                  int32_t* table, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (bits < 1 || bits > 8 || (src_bytes != 4 && src_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned tiles = static_cast<unsigned>((n + kTile - 1) / kTile);
  const unsigned mask = (1u << bits) - 1u;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_bytes == 4) {
    radix_hist_kernel<int32_t><<<tiles, kHistThreads, 0, s>>>(
        static_cast<const int32_t*>(src), n, mask, table);
  } else {
    radix_hist_kernel<int64_t><<<tiles, kHistThreads, 0, s>>>(
        static_cast<const int64_t*>(src), n, mask, table);
  }
  return static_cast<int>(cudaGetLastError());
}

// B2. digits: (n,) int32 in [0, 256); table: each (digit, tile)'s offset
// within its digit; out: (n,) int32, each row's stable rank among all rows
// of its digit.
int vt_radix_rank(const int32_t* digits, int64_t n, const int32_t* table,
                  int32_t* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned tiles = static_cast<unsigned>((n + kTile - 1) / kTile);
  radix_rank_kernel<<<tiles, kRankThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(digits, n, table,
                                                           out);
  return static_cast<int>(cudaGetLastError());
}

// B3, positions. digits: (n,) int32 in [0, 256), 16-byte aligned; table:
// each (digit, tile)'s first destination; out: (n,) int32.
int vt_radix_pos(const int32_t* digits, int64_t n, const int32_t* table,
                 int32_t* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(place<int32_t, kPositions>(
      digits, 8, n, table, out, static_cast<cudaStream_t>(stream)));
}

// B3, scatter. state: (n,) int64 sort state, 16-byte aligned, its digit
// the low `bits` bits (1..8); table: each (digit, tile)'s first
// destination; out: (n,) int64, out[destination] = (uint64)state >> bits.
int vt_radix_scatter(const int64_t* state, int bits, int64_t n,
                     const int32_t* table, int64_t* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (bits < 1 || bits > 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(place<int64_t, kScatter>(
      state, bits, n, table, out, static_cast<cudaStream_t>(stream)));
}

// Resident blocks per SM and dynamic shared memory of B3's kernels:
// which = 0 positions, 1 scatter.
int vt_radix_place_occupancy(int which, int* blocks, int* smem) {
  return static_cast<int>(
      which == 0 ? place_occupancy<int32_t, kPositions>(blocks, smem)
                 : place_occupancy<int64_t, kScatter>(blocks, smem));
}

}  // extern "C"
