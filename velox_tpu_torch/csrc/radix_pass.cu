// One 8-bit counting-sort pass on Hopper: digit histogram, stable ranks,
// and destinations or the scattered next sort state.
//
// Replaces three Pallas kernels of velox_tpu/ops/pallas_kernels.py:
//
//   B4 _radix_hist_kernel (:85, pallas_call :106) -> radix_hist_kernel<T>
//   B3 _radix_pos_kernel  (:116, pallas_call :158) -> radix_place_kernel
//      with the positions epilogue, and the scatter epilogue that also
//      moves the int64 sort state
//   B2 _radix_rank_kernel (:45, pallas_call :207) -> radix_place_kernel
//      too: with the positions epilogue (the rank form), and the
//      rank-and-scatter epilogue that moves a 32-bit sort word and the
//      permutation (the classic loop's pass)
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
//      (or, scanned per digit, its offset within the digit, for B2's rank
//      form).
//   3. radix_place_kernel gives every row its stable rank among the
//      tile's rows of its digit and adds the table entry of (digit, tile).
//      B2 is B3's function over another table, so both run on this one
//      kernel: the positions epilogue is B3's positions and B2's rank
//      form alike, with the table each is given.
//
// A digit comes from an int32 digit array (the reference's whole-pass
// functions), from the int64 sort state of the scatter branch, or from
// the int32 sort word of the classic loop; in the last two it is the low
// `bits` bits, taken in the kernel, so neither branch has a row-sized
// digit tensor. The scatter epilogue writes the state's remaining bits,
// (uint64)state >> bits, to the row's destination; the rank-and-scatter
// epilogue writes (uint32)word >> bits and the row's permutation entry
// there (or the permutation alone, once the word is spent). So one pass
// of either branch is two launches (histogram, place-and-scatter) and
// the 256 x n_tiles scan.
//
// What bounds them: device memory. Per row, the histogram reads 8 bytes
// of state (4 of digits or a word); place-and-scatter reads 8 and writes
// 8, rank-and-scatter reads 8 (word, permutation) and writes 8 (4 on a
// word's last pass); positions read 4 and write 4; plus the table. The
// design follows:
//
// * radix_hist_kernel: each of 512 threads loads its 16 rows of the tile
//   with 16-byte loads, all issued before the first is used (the digits
//   wait four to a register), and counts them with shared-memory atomics
//   into its warp's own histogram (a histogram is order-free: no ranks).
//   A thread adds a run of equal digits once, so a tile of one digit (32
//   lanes on one address) costs one atomic a thread, not one a row.
// * radix_place_kernel: one block of 512 threads takes the whole tile into
//   shared memory first (dynamic shared memory: 64 KB of state, or 32 KB
//   of words and 32 KB of the permutation), by cp.async.bulk copies
//   completed on one mbarrier (on an H100 80GB HBM3 at 700 W the copy
//   beat 16-byte vector loads of the same tile by 1-6% in each of eight
//   timed cells: scatter and positions, 6.7M and 60M rows, uniform and
//   one-digit tiles). Then warp w ranks rows [512 w, 512 w + 512) in 16
//   steps of 32 rows: the lanes holding the same digit are found by a
//   multi-split over the digit's bits (one __ballot_sync per bit, as
//   CUB's block radix rank does), a row's rank among them is the popcount
//   of the lower lanes, and the lowest of them adds the group's size to
//   the warp's counter of that digit. The steps of a warp depend on each
//   other only through that counter in shared memory; no load from device
//   memory sits inside the chain (B2's first form, 8 warps with
//   __match_any_sync ranks, loaded a digit in every step, which left few
//   loads in flight: its time was latency, not bytes, see PERF.md), and
//   the 32 warps of two resident blocks hide the rest. Warp counters
//   become offsets in warp order and a 256-digit scan gives each digit's
//   first slot in the tile.
//   - positions epilogue: out[row] = table[d, tile] + rank in tile, with
//     each warp storing 32 consecutive rows.
//   - scatter and rank-and-scatter epilogues: every row's slot in the
//     tile (digit order, stable) receives its row number in shared
//     memory; then thread t walks slots t, t + 512, ... and writes the
//     slot's shifted state, or its shifted word and permutation entry, to
//     table[d, tile] + (slot - first slot of d): neighbouring threads
//     store to neighbouring addresses inside each digit's run.
//   Tried on the H100 and slower: __match_any_sync instead of the ballots
//   (faster only on one-digit tiles), two interleaved rank chains a warp,
//   a third resident block, and one persistent 1024-thread block per SM
//   that copies the next tile while it ranks the current one: the rank
//   and write phases, not the loads, set the time of a tile.
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
// B3 and B2: place (positions, scatter, or rank-and-scatter)
// ---------------------------------------------------------------------------

constexpr int kPlaceThreads = 512;
constexpr int kPlaceWarps = kPlaceThreads / 32;
constexpr int kPlaceWarpRows = kTile / kPlaceWarps;
constexpr int kPlaceSteps = kPlaceWarpRows / 32;  // rows a lane ranks
constexpr int kPositions = 0;    // B3's positions, B2's rank form
constexpr int kScatter = 1;      // B3: the int64 sort state
constexpr int kRankScatter = 2;  // B2: the int32 word and permutation
static_assert(kPlaceThreads >= kRadix, "the scan maps a thread to a digit");

template <typename T, int kEpilogue>
struct PlaceSmem {
  T src[kTile];  // the tile's digits, state or word
  // the tile's permutation entries (the rank-and-scatter epilogue only)
  int32_t perm[kEpilogue == kRankScatter ? kTile : 1];
  // slot -> row of the tile (the scatter epilogues only)
  uint16_t slot_row[kEpilogue == kPositions ? 1 : kTile];
  // each warp's count of every digit, then its offset within the tile's
  // rows of that digit
  uint16_t warp_off[kPlaceWarps][kRadix];
  int start[kRadix];  // the tile's first slot of each digit
  int base[kRadix];   // table[d, tile]
  int scan[kRadix / 32];
  unsigned long long bar;  // the bulk copies' mbarrier
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

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The rows of a tile that a bulk copy moves: the 16-byte multiple.
template <typename T>
__device__ __forceinline__ int bulk_rows(int rows) {
  return rows & ~(16 / static_cast<int>(sizeof(T)) - 1);
}

// Brings the tile's `rows` rows of src (and of perm, for the
// rank-and-scatter epilogue) into shared memory, visible to every thread
// on return: one thread starts a cp.async.bulk copy of each array's
// 16-byte multiple, both completing on one mbarrier; plain loads take the
// at most 3 int32 or 1 int64 rows past it.
template <typename T, int kEpilogue>
__device__ __forceinline__ void load_tile(PlaceSmem<T, kEpilogue>& s,
                                          const T* tile, const int32_t* perm,
                                          int rows) {
  constexpr bool kPerm = kEpilogue == kRankScatter;
  const int tid = threadIdx.x;
  const int src_rows = bulk_rows<T>(rows);
  const int perm_rows = kPerm ? bulk_rows<int32_t>(rows) : rows;
  const int bytes = src_rows * static_cast<int>(sizeof(T)) +
                    (kPerm ? perm_rows * 4 : 0);
  const uint32_t bar = smem_addr(&s.bar);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (bytes > 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(bytes)
          : "memory");
      if (src_rows > 0) {
        bulk_copy(s.src, tile, src_rows * static_cast<int>(sizeof(T)), bar);
      }
      if (kPerm && perm_rows > 0) bulk_copy(s.perm, perm, perm_rows * 4, bar);
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                   : "memory");
    }
  }
  for (int r = src_rows + tid; r < rows; r += kPlaceThreads) {
    s.src[r] = tile[r];
  }
  if constexpr (kPerm) {
    for (int r = perm_rows + tid; r < rows; r += kPlaceThreads) {
      s.perm[r] = perm[r];
    }
  }
  __syncthreads();  // the barrier is initialised, the tails stored
  mbar_wait(bar, 0);
}

// bits: the digit's width (8 for int32 digits); the table holds each
// (digit, tile)'s first destination (or offset within the digit).
// - kPositions: src is (n,) int32 digits; out is (n,) int32, table[d,
//   tile] + the row's stable rank among the tile's rows of digit d.
// - kScatter: src is the (n,) int64 state; out is (n,) int64, and the
//   row's (uint64)state >> bits goes to that position.
// - kRankScatter: src is the (n,) int32 word, perm the (n,) int32
//   permutation; the row's (uint32)word >> bits goes to that position of
//   out (unless out is null: the word is spent) and perm[row] to that
//   position of perm_out.
template <typename T, int kEpilogue>
__global__ void __launch_bounds__(kPlaceThreads, 2)
radix_place_kernel(const T* __restrict__ src,
                   const int32_t* __restrict__ perm, int64_t n, int bits,
                   const int32_t* __restrict__ table, void* __restrict__ out,
                   int32_t* __restrict__ perm_out) {
  static_assert(kEpilogue != kScatter || sizeof(T) == 8,
                "the scatter epilogue moves the int64 sort state");
  static_assert(kEpilogue != kRankScatter || sizeof(T) == 4,
                "the rank-and-scatter epilogue moves a 32-bit word");
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
  load_tile<T, kEpilogue>(s, src + tile_start,
                          kEpilogue == kRankScatter ? perm + tile_start
                                                    : nullptr,
                          rows);

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
    for (int slot = tid; slot < rows; slot += kPlaceThreads) {
      const int r = s.slot_row[slot];
      if constexpr (kEpilogue == kScatter) {
        const uint64_t v = static_cast<uint64_t>(s.src[r]);
        const unsigned d = static_cast<unsigned>(v) & mask;
        static_cast<uint64_t*>(out)[static_cast<int64_t>(s.base[d]) +
                                    (slot - s.start[d])] = v >> bits;
      } else {
        const uint32_t v = static_cast<uint32_t>(s.src[r]);
        const unsigned d = v & mask;
        const int64_t dst = static_cast<int64_t>(s.base[d]) +
                            (slot - s.start[d]);
        if (out != nullptr) static_cast<uint32_t*>(out)[dst] = v >> bits;
        perm_out[dst] = s.perm[r];
      }
    }
  }
}

// Lets one place kernel take its shared memory, once per device.
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
cudaError_t place(const T* src, const int32_t* perm, int bits, int64_t n,
                  const int32_t* table, void* out, int32_t* perm_out,
                  cudaStream_t stream) {
  const cudaError_t err = place_setup<T, kEpilogue>();
  if (err != cudaSuccess) return err;
  const unsigned tiles = static_cast<unsigned>((n + kTile - 1) / kTile);
  radix_place_kernel<T, kEpilogue>
      <<<tiles, kPlaceThreads, sizeof(PlaceSmem<T, kEpilogue>), stream>>>(
          src, perm, n, bits, table, out, perm_out);
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

// B4. src: (n,) int32 digits or word (src_bytes 4) or the int64 sort state
// (src_bytes 8), whose digit is its low `bits` bits (1..8; 8 for digits).
// table: (256, n_tiles) int32, written. n < 2^31; src 16-byte aligned.
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

// B3, positions. digits: (n,) int32 in [0, 256), 16-byte aligned; table:
// each (digit, tile)'s first destination; out: (n,) int32.
int vt_radix_pos(const int32_t* digits, int64_t n, const int32_t* table,
                 int32_t* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(
      place<int32_t, kPositions>(digits, nullptr, 8, n, table, out, nullptr,
                                 static_cast<cudaStream_t>(stream)));
}

// B2, rank form: the same kernel given each (digit, tile)'s offset within
// its digit, so out (n,) int32 is each row's stable rank among all rows
// of its digit.
int vt_radix_rank(const int32_t* digits, int64_t n, const int32_t* table,
                  int32_t* out, void* stream) {
  return vt_radix_pos(digits, n, table, out, stream);
}

// B3, scatter. state: (n,) int64 sort state, 16-byte aligned, its digit
// the low `bits` bits (1..8); table: each (digit, tile)'s first
// destination; out: (n,) int64, out[destination] = (uint64)state >> bits.
int vt_radix_scatter(const int64_t* state, int bits, int64_t n,
                     const int32_t* table, int64_t* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (bits < 1 || bits > 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      place<int64_t, kScatter>(state, nullptr, bits, n, table, out, nullptr,
                               static_cast<cudaStream_t>(stream)));
}

// B2, rank and scatter. word, perm: (n,) int32, 16-byte aligned; the
// word's digit is its low `bits` bits (1..8); table: each (digit, tile)'s
// first destination. word_out[destination] = (uint32)word >> bits (skipped
// when word_out is null), perm_out[destination] = perm.
int vt_radix_rank_scatter(const int32_t* word, const int32_t* perm, int bits,
                          int64_t n, const int32_t* table, int32_t* word_out,
                          int32_t* perm_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (bits < 1 || bits > 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(place<int32_t, kRankScatter>(
      word, perm, bits, n, table, word_out, perm_out,
      static_cast<cudaStream_t>(stream)));
}

// Resident blocks per SM and dynamic shared memory of the place kernels:
// which = 0 positions (B3, B2's rank form), 1 scatter (B3), 2 rank and
// scatter (B2).
int vt_radix_place_occupancy(int which, int* blocks, int* smem) {
  switch (which) {
    case 0:
      return static_cast<int>(
          place_occupancy<int32_t, kPositions>(blocks, smem));
    case 1:
      return static_cast<int>(
          place_occupancy<int64_t, kScatter>(blocks, smem));
    case 2:
      return static_cast<int>(
          place_occupancy<int32_t, kRankScatter>(blocks, smem));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
