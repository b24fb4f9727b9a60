// Batched masked popcount-intersection over packed bitsets, for Hopper
// (sm_90a):
//
//     counts[r, c] = popcount(a[r] & mask[r] & b[c])      int32 [B, N]
//
// a and mask are [B, W], b is [N, W], all row-major 32-bit words (the
// wrapper passes int32 tensors, read here as uint32); mask may be null.
//
// Replaces the TPU kernel repro/kernels/masked_intersect.py::_kernel and
// ::_kernel_masked (launched by _masked_intersect through pl.pallas_call).
// Both forms are each kernel below: a null mask pointer is the mask-free
// _kernel, which clique child scoring reaches through frontier_expand.
//
// Three kernels, one C entry; the wrapper picks one per call in Python
// (masked_intersect.py::_plan) and passes its choice here.
//
// * masked_intersect_kernel_mma, the tensor-core kernel, for every call
//   wider than the row kernel's cut-over (clique and iso: B = 64, N =
//   32,768, W = 1,024).  The count is a product of 0/1 vectors over the
//   K = 32 W bits, popcount(x & y) = sum_k bit_k(x) bit_k(y), and Hopper's
//   wgmma computes it in its 1-bit form,
//   wgmma.mma_async.m64n64k256.s32.b1.b1.and.popc: each k256 step adds
//   popc(a & b) over 256 bits to an s32 sum, exactly, from the packed
//   words as they are.  Bound at the main shape by its bytes: 143 MB of
//   compulsory traffic (b once: 134 MB), 0.0426 ms at 3.35 TB/s.  Its
//   2 B N K = 1.374e11 operations would take 0.0694 ms at the H100's
//   1,979 TOP/s of dense int8, the data sheet's narrowest tensor-core
//   type, but NVIDIA publishes no 1-bit rate and scripts/mi_ceilings.py
//   measures the 1-bit form at 8x the u8 form's bits a second, so the
//   operations take well under the bytes' time: the design streams b and
//   keeps the tensor cores off the critical path.
//   (On the CUDA cores the same call is 2.15e9 word popcounts, 0.51 ms
//   at 16 popcounts a clock an SM: the bound of the tile below.)
//
//   A block owns 64 rows of a and 256 columns of b (two tiles of 64 columns a
//   consumer warpgroup; 128 columns a block measured slower) and walks all of
//   K.  b's columns are the A operand (M = 64 columns, from registers): a
//   thread's fragment of a k256 step is words t and t + 4 of the step of its
//   two columns, read from shared memory as they are.  (a & mask)'s 64 rows
//   are the B operand (N = 64, K-major in shared memory, no swizzle: core
//   matrices of 8 rows x 16 bytes, the two 16-byte halves of a step 128 B
//   apart, 8-row groups 256 B apart), ANDed once a block and read by all four
//   tiles; a null mask skips the AND.  Three warpgroups, a producer and two
//   consumers, share a ring of three slots of 32 words (the raw words of b, a
//   and mask, and a & mask in the B layout: 62 KB a slot), with a full and an
//   empty mbarrier a slot.  The producer copies raw words in by cp.async (16
//   bytes a copy when W % 4 == 0 and the pointers are 16-byte aligned, else
//   4), zero-filled past B, N and W, so the ragged edges read as zero words
//   (no padding) and are never stored; 32 words make 128 B a column a stage,
//   which b's stream needs to approach the card's rate.  It ANDs a slot's a
//   and mask while the consumers multiply the slot before it, and refills a
//   slot once the consumers release it.  A consumer warpgroup builds the
//   fragments of its slot's 4 steps x 2 tiles, issues them as one commit group
//   of wgmma and waits for it: ptxas serializes every wgmma of a group whose
//   input registers are defined while an earlier group still runs.  The
//   accumulators (32 s32 registers a tile) are the counts, stored from
//   registers.  One grid: blockIdx.x runs over every (row tile, column tile),
//   column tiles fastest, so any B and N of the wrapper's range take one
//   launch.
//
// * the tile, masked_intersect_kernel, the first port's 64 x 64 tile on the
//   CUDA cores, reached only when the wrapper is asked for it (plan TILE: the
//   smoke run's in-run yardstick).  Each block owns a 64-row x 64-column tile
//   of the output and loops over W in chunks of 32 words.  Per chunk it stages
//   (a & mask) and b in shared memory, transposed so that a thread's operands
//   for one word sit in one shared row; each of the 256 threads then keeps
//   a 4 x 4 tile of counts in registers, so every popcount costs half a shared
//   load, and the popcount pipe, not shared memory, sets the pace.  Rows and
//   columns of a thread are 16 apart, which makes the column reads of a warp
//   16 consecutive words (no bank conflicts) and the row reads two broadcast
//   words; the shared pitch of 65 words makes the transposing stores
//   conflict-free too.  The ragged edges of B, N and W read as zero words and
//   are never stored.  Row tiles go on blockIdx.y, whose grid limit is 65,535
//   tiles (B <= 4,194,240 rows); a taller call is launched as one grid per
//   4,194,240 rows, each on its own slice of a, mask and out.
//
// * the row-streaming variant, masked_intersect_kernel_rows, for narrow
//   calls (N at most the cut-over; the pattern edge probe is [Ep <=
//   1,024 rows] x [1 column] x [W words] with a row mask).  There a
//   64-column tile leaves 63 of its columns empty, puts one block on each
//   of Ep / 64 SMs and walks W in series: 0.23 ms at 1,024 x 1 x 1,024,
//   against a bytes bound of a few microseconds (8.4 MB).  The call is
//   bound by bytes, so the row variant spreads rows over the whole card:
//   `lanes` threads of a warp (32, or fewer for a short row) own one row,
//   the grid is one-dimensional over rows (2^31 - 1 blocks: any B < 2^31
//   in one grid), and each lane streams its row's words 16 bytes at a
//   time (uint4 of a and of mask, neighbouring lanes on neighbouring
//   words), ANDs them and keeps one __popc sum per column of b in
//   registers.  b (N x W words, a few KB for the probe) is read through
//   the read-only cache and stays in L1 and L2.  The column sums are
//   reduced across the row's lanes by xor shuffles and stored by the
//   lanes, one column each.  A call of more columns than a lane keeps in
//   registers (COLS, a template) takes one pass over the row per COLS
//   columns.  A row of W % 4 != 0 words, or a base pointer that is not
//   16-byte aligned, takes the same kernel one word at a time (VEC =
//   false).
#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;
constexpr int kTileCols = 64;
constexpr int kChunk = 32;                 // words staged per step
constexpr int kThreads = 256;              // 16 x 16, each 4 x 4 outputs
constexpr int kPitch = kTileRows + 1;      // shared row pitch, in words

static_assert(kTileRows == kTileCols, "one staging loop serves both tiles");
static_assert(kTileRows * kChunk % kThreads == 0, "even staging split");

__global__ void __launch_bounds__(kThreads)
masked_intersect_kernel(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ mask,
                        const uint32_t* __restrict__ b,
                        int32_t* __restrict__ out, int B, int N, int W) {
  // as[k][r] = (a & mask)[row0 + r][k0 + k], bs[k][c] = b[col0 + c][k0 + k]
  __shared__ uint32_t as[kChunk][kPitch];
  __shared__ uint32_t bs[kChunk][kPitch];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileCols;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < W; k0 += kChunk) {
    // 32 consecutive threads read 32 consecutive words of one row
#pragma unroll
    for (int s = 0; s < kTileRows * kChunk / kThreads; ++s) {
      const int idx = tid + s * kThreads;
      const int r = idx / kChunk;
      const int k = idx % kChunk;
      const int gk = k0 + k;
      uint32_t av = 0, bv = 0;
      if (gk < W) {
        if (row0 + r < B) {
          const size_t off = static_cast<size_t>(row0 + r) * W + gk;
          av = a[off];
          if (mask != nullptr) av &= mask[off];
        }
        if (col0 + r < N) bv = b[static_cast<size_t>(col0 + r) * W + gk];
      }
      as[k][r] = av;
      bs[k][r] = bv;
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      uint32_t ra[4], rb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) rb[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __popc(ra[i] & rb[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) out[static_cast<size_t>(r) * N + c] = acc[i][j];
    }
  }
}

constexpr int kRowThreads = 128;          // row variant: 4 warps a block

// counts[row, c] for every c < N: `lanes` threads a row (a power of two
// <= 32), COLS column sums a lane in registers, loads of 16 bytes (VEC) or
// of one word
template <int COLS, bool VEC>
__global__ void __launch_bounds__(kRowThreads)
masked_intersect_kernel_rows(const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ mask,
                             const uint32_t* __restrict__ b,
                             int32_t* __restrict__ out, int B, int N, int W,
                             int lanes) {
  using Unit = typename std::conditional<VEC, uint4, uint32_t>::type;
  constexpr int kWords = VEC ? 4 : 1;       // words of one load
  constexpr int kUnroll = COLS <= 2 ? 4 : 1;
  const int lane = threadIdx.x & (lanes - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) *
                          (kRowThreads / lanes) + threadIdx.x / lanes;
  const bool live = row < B;
  // every lane of the warp reaches the shuffles; a lane past B streams
  // nothing and stores nothing
  const int units = live ? W / kWords : 0;
  const size_t row_off = static_cast<size_t>(live ? row : 0) * W;
  const Unit* ar = reinterpret_cast<const Unit*>(a + row_off);
  const Unit* mr = mask == nullptr
                       ? nullptr
                       : reinterpret_cast<const Unit*>(mask + row_off);

  for (int64_t c0 = 0; c0 < N; c0 += COLS) {
    int acc[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = 0;

#pragma unroll (kUnroll)
    for (int u = lane; u < units; u += lanes) {
      Unit x = __ldg(ar + u);
      if (mr != nullptr) {
        const Unit m = __ldg(mr + u);
        if constexpr (VEC) {
          x.x &= m.x; x.y &= m.y; x.z &= m.z; x.w &= m.w;
        } else {
          x &= m;
        }
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        if (c0 + c < N) {
          const Unit y = __ldg(reinterpret_cast<const Unit*>(
                                   b + static_cast<size_t>(c0 + c) * W) +
                              u);
          if constexpr (VEC) {
            acc[c] += __popc(x.x & y.x) + __popc(x.y & y.y) +
                      __popc(x.z & y.z) + __popc(x.w & y.w);
          } else {
            acc[c] += __popc(x & y);
          }
        }
      }
    }

#pragma unroll
    for (int c = 0; c < COLS; ++c)
      for (int off = lanes >> 1; off > 0; off >>= 1)
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off, lanes);
    if (live) {
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        if ((c & (lanes - 1)) == lane && c0 + c < N)
          out[static_cast<size_t>(row) * N + static_cast<size_t>(c0 + c)] =
              acc[c];
    }
  }
}

template <int COLS>
cudaError_t launch_rows(const uint32_t* a, const uint32_t* mask,
                        const uint32_t* b, int32_t* out, int B, int N, int W,
                        int lanes, bool vector, cudaStream_t stream) {
  const int rows_per_block = kRowThreads / lanes;
  const unsigned blocks =
      static_cast<unsigned>((static_cast<int64_t>(B) + rows_per_block - 1) /
                            rows_per_block);
  if (vector)
    masked_intersect_kernel_rows<COLS, true><<<blocks, kRowThreads, 0,
                                               stream>>>(a, mask, b, out, B,
                                                         N, W, lanes);
  else
    masked_intersect_kernel_rows<COLS, false><<<blocks, kRowThreads, 0,
                                                stream>>>(a, mask, b, out, B,
                                                          N, W, lanes);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// one grid for up to kMaxGridRows rows, one grid per kMaxGridRows-row
// slice of a taller call
cudaError_t launch_tile(const uint32_t* a, const uint32_t* mask,
                        const uint32_t* b, int32_t* out, int B, int N, int W,
                        cudaStream_t stream) {
  constexpr int64_t kMaxGridRows = 65535 * kTileRows;   // gridDim.y limit
  for (int64_t row0 = 0; row0 < B; row0 += kMaxGridRows) {
    const int rows = static_cast<int>(
        B - row0 < kMaxGridRows ? B - row0 : kMaxGridRows);
    const size_t in_off = static_cast<size_t>(row0) * W;
    const dim3 grid((N + kTileCols - 1) / kTileCols,
                    (rows + kTileRows - 1) / kTileRows);
    masked_intersect_kernel<<<grid, kThreads, 0, stream>>>(
        a + in_off, mask == nullptr ? nullptr : mask + in_off, b,
        out + static_cast<size_t>(row0) * N, rows, N, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------- mma
constexpr int kConsumerGroups = 2;        // warpgroups that multiply
constexpr int kConsumers = 128 * kConsumerGroups;
constexpr int kMmaThreads = kConsumers + 128;   // and one producer
constexpr int kMmaRows = 64;              // rows of a a block: wgmma's N
constexpr int kStepWords = 8;             // words of one k256 step
constexpr int kStageWords = 32;           // words of K a ring slot
constexpr int kSteps = kStageWords / kStepWords;
constexpr int kRing = 3;                  // ring slots
constexpr int kRawPitch = kStageWords + 4;   // words: 144 B, so the 8
                                             // fragment rows of a warp
                                             // sit in distinct banks
constexpr int kStepBytes = kMmaRows * 32;    // one k256 step of 64 rows
static_assert(kMmaRows * kStageWords / 4 % 128 == 0,
              "(row, 4 words) pairs of a slot split evenly over the "
              "producer");

constexpr int kTiles = 2;                 // tiles of 64 columns a consumer
constexpr int kMmaCols = kConsumerGroups * 64 * kTiles;  // b columns a block
constexpr int kAnd = kSteps * kStepBytes;  // a & mask of a slot, 8 KB
constexpr int kRawB = kMmaCols * kRawPitch * 4;
constexpr int kRawA = kMmaRows * kRawPitch * 4;
// a slot: a & mask in the B operand's layout, then the raw words of b, a
// and mask; the slots, then a full and an empty mbarrier per slot
constexpr int kSlot = kAnd + kRawB + 2 * kRawA;
constexpr size_t kMmaSmemBytes = kRing * kSlot + 2 * kRing * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one copy of 16 bytes (VEC) or 4 into shared memory; zero-filled unless
// `live` (src is then not read)
template <bool VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const uint32_t* src,
                                         bool live) {
  if constexpr (VEC)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(live ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(live ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the producer warpgroup's own barrier
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until phase number `parity` (mod 2) of the barrier has completed; a
// wait of 2^26 polls (seconds) traps, so that a fault in the ring's
// bookkeeping fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == 1u << 26) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins an accumulator's registers in place around the asynchronous wgmma
__device__ __forceinline__ void fence_acc(int32_t (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// K-major operand without swizzle: 8-row x 16-byte core matrices, the two
// 16-byte halves of a k256 step 128 B apart (leading byte offset), 8-row
// groups 256 B apart (stride byte offset); all in 16-byte units
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>(128 >> 4) << 16 |
         static_cast<uint64_t>(256 >> 4) << 32;
}

// d (64 x 64, s32) += popc(a & b) over k256: a (64 x 256 bits, registers:
// 4 words a thread), b (256 bits x 64, shared memory through its
// descriptor, K-major)
__device__ __forceinline__ void wgmma_and_popc(int32_t (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the producer's copies of words [w0, w0 + kStageWords) of the block's b
// columns, a rows and mask rows into `slot`; past N, B or W zero-filled
template <bool VEC>
__device__ __forceinline__ void load_stage(
    uint32_t slot, int ptid, const uint32_t* a, const uint32_t* mask,
    const uint32_t* b, int64_t row0, int64_t col0, int B, int N, int W,
    int w0) {
  constexpr int kUnit = VEC ? 4 : 1;                 // words a copy
  constexpr int kUnitsRow = kStageWords / kUnit;
  const uint32_t raw_b = slot + kAnd;
  const uint32_t raw_a = raw_b + kRawB;
  const uint32_t raw_m = raw_a + kRawA;
#pragma unroll 4
  for (int i = 0; i < kMmaCols * kUnitsRow / 128; ++i) {
    const int id = ptid + i * 128;
    const int c = id / kUnitsRow;
    const int k = (id % kUnitsRow) * kUnit;
    const bool live = col0 + c < N && w0 + k < W;
    cp_async<VEC>(raw_b + (c * kRawPitch + k) * 4,
                  live ? b + (col0 + c) * W + w0 + k : b, live);
  }
#pragma unroll 4
  for (int i = 0; i < kMmaRows * kUnitsRow / 128; ++i) {
    const int id = ptid + i * 128;
    const int r = id / kUnitsRow;
    const int k = (id % kUnitsRow) * kUnit;
    const bool live = row0 + r < B && w0 + k < W;
    const int64_t off = live ? (row0 + r) * W + w0 + k : 0;
    cp_async<VEC>(raw_a + (r * kRawPitch + k) * 4, a + off, live);
    if (mask != nullptr)
      cp_async<VEC>(raw_m + (r * kRawPitch + k) * 4, mask + off, live);
  }
}

// One block: 64 rows of a (& mask) by kMmaCols columns of b, over all W
// words; the source note has the design
template <bool VEC>
__global__ void __launch_bounds__(kMmaThreads, 1)
masked_intersect_kernel_mma(const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ mask,
                            const uint32_t* __restrict__ b,
                            int32_t* __restrict__ out, int B, int N, int W,
                            int col_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / col_tiles) *
                       kMmaRows;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x % col_tiles) *
                       kMmaCols;
  const int stages = (W + kStageWords - 1) / kStageWords;
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + kRing * kSlot;     // producer -> consumers
  const uint32_t empty = full + kRing * 8;           // consumers -> producer
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full + 8 * i, 128);
      mbar_init(empty + 8 * i, kConsumers);
    }
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: raw words in by cp.async, a & mask into the B
    // operand's layout
    const int ptid = tid - kConsumers;
#pragma unroll
    for (int s = 0; s < kRing - 1; ++s) {
      if (s < stages)
        load_stage<VEC>(ring + s * kSlot, ptid, a, mask, b, row0,
                            col0, B, N, W, s * kStageWords);
      cp_async_commit();
    }
    for (int s = 0; s < stages; ++s) {
      const int slot = s % kRing;
      unsigned char* anded = smem + slot * kSlot;
      const unsigned char* raw = anded + kAnd + kRawB;
      cp_async_wait<kRing - 2>();       // this thread's copies of stage s
      producer_sync();                  // everyone's
      // a thread = (row r, words 4 u .. 4 u + 3): the 16-byte half u % 2
      // of k256 step u / 2 of row r
      for (int pair = ptid; pair < kMmaRows * kStageWords / 4;
           pair += 128) {
        const int r = pair % kMmaRows;
        const int u = pair / kMmaRows;
        const int off = (r * kRawPitch + 4 * u) * 4;
        uint4 x = *reinterpret_cast<const uint4*>(raw + off);
        if (mask != nullptr) {
          const uint4 m =
              *reinterpret_cast<const uint4*>(raw + kRawA + off);
          x.x &= m.x; x.y &= m.y; x.z &= m.z; x.w &= m.w;
        }
        *reinterpret_cast<uint4*>(anded + (u / 2) * kStepBytes +
                                  (r / 8) * 256 + (u % 2) * 128 +
                                  (r % 8) * 16) = x;
      }
      fence_proxy_async();
      mbar_arrive(full + 8 * slot);
      // stage s + kRing - 1 into the slot of stage s - 1, once the
      // consumers are done with it
      const int next = s + kRing - 1;
      if (next < stages) {
        if (next >= kRing)
          mbar_wait(empty + 8 * (next % kRing), (next / kRing - 1) & 1);
        load_stage<VEC>(ring + (next % kRing) * kSlot, ptid, a, mask,
                            b, row0, col0, B, N, W, next * kStageWords);
      }
      cp_async_commit();
    }
    return;
  }

  // ---- consumers: b's words as register fragments, wgmma against the
  // slot's a & mask
  const int wg = tid / 128;
  const int wi = (tid / 32) % 4;            // warp of the warpgroup
  const int g = (tid % 32) / 4;             // fragment row (of 8)
  const int t = tid % 4;                    // fragment word (of 4)
  // this thread's A-fragment columns of tile j: cols[j] and cols[j] + 8
  int cols[kTiles];
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
    cols[j] = (wg * kTiles + j) * 64 + 16 * wi + g;

  int32_t acc[kTiles][32];
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0;

  for (int s = 0; s < stages; ++s) {
    const int slot = s % kRing;
    mbar_wait(full + 8 * slot, (s / kRing) & 1);
    const uint32_t* raw_b = reinterpret_cast<const uint32_t*>(
        smem + slot * kSlot + kAnd);
    const uint32_t anded = ring + slot * kSlot;
    // the fragment of k256 step st: words t and t + 4 of the step, of
    // columns cols[j] (registers 0, 2) and cols[j] + 8 (1, 3).  All of a
    // stage's fragments and descriptors are defined before its first
    // wgmma, and each warpgroup waits for its group before the next
    // stage: ptxas serializes the wgmmas of a group whose input
    // registers are defined while an earlier group still runs
    uint32_t frag[kSteps][kTiles][4];
    uint64_t desc[kSteps];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const uint32_t* x = raw_b + cols[j] * kRawPitch + st * kStepWords;
        const uint32_t* y = x + 8 * kRawPitch;
        frag[st][j][0] = x[t];
        frag[st][j][1] = y[t];
        frag[st][j][2] = x[t + 4];
        frag[st][j][3] = y[t + 4];
      }
      desc[st] = kmajor_desc(anded + st * kStepBytes);
    }
#pragma unroll
    for (int j = 0; j < kTiles; ++j) fence_acc(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
        wgmma_and_popc(acc[j], frag[st][j], desc[st]);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < kTiles; ++j) fence_acc(acc[j]);
    mbar_arrive(empty + 8 * slot);      // the slot's words all read
  }

  // accumulator register 4 nb + e: column (of the tile's 64) 16 wi + g
  // (+ 8 for e >= 2), row 8 nb + 2 t + (e & 1)
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t col = col0 + cols[j] + (e >= 2 ? 8 : 0);
      if (col >= N) continue;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int64_t row = row0 + 8 * nb + 2 * t + (e & 1);
        if (row < B) out[row * N + col] = acc[j][4 * nb + e];
      }
    }
  }
}

template <bool VEC>
cudaError_t launch_mma(const uint32_t* a, const uint32_t* mask,
                       const uint32_t* b, int32_t* out, int B, int N, int W,
                       cudaStream_t stream) {
  const auto kernel = masked_intersect_kernel_mma<VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmaSmemBytes));
  if (err != cudaSuccess) return err;
  const int64_t col_tiles = (static_cast<int64_t>(N) + kMmaCols - 1) /
                            kMmaCols;
  const int64_t blocks =
      col_tiles * ((static_cast<int64_t>(B) + kMmaRows - 1) / kMmaRows);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kMmaThreads, kMmaSmemBytes,
           stream>>>(a, mask, b, out, B, N, W, static_cast<int>(col_tiles));
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// variant 0 is the tile (lanes, vector and cols unused); variant 1 the
// row-streaming kernel with `lanes` threads a row (1, 2, ..., 32), 16-byte
// loads if `vector` (W % 4 == 0 and a, mask, b 16-byte aligned), `cols`
// column sums a lane (1, 2, ..., 32); variant 2 the mma kernel, `cols` =
// 256 columns of b a block, 16-byte copies if `vector` (as for the row
// kernel; lanes unused).  A plan the kernels cannot run is refused with
// cudaErrorInvalidValue before anything launches.
extern "C" int masked_intersect_launch(const void* a, const void* mask,
                                       const void* b, void* out, int B,
                                       int N, int W, int variant, int lanes,
                                       int vector, int cols, void* stream) {
  const auto* a32 = static_cast<const uint32_t*>(a);
  const auto* m32 = static_cast<const uint32_t*>(mask);
  const auto* b32 = static_cast<const uint32_t*>(b);
  auto* o32 = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == 0) return static_cast<int>(launch_tile(a32, m32, b32, o32,
                                                        B, N, W, s));
  const bool vec_ok = W % 4 == 0 && aligned16(a) && aligned16(b) &&
                      (mask == nullptr || aligned16(mask));
  if (variant == 2) {
    if ((vector && !vec_ok) || cols != kMmaCols)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        vector ? launch_mma<true>(a32, m32, b32, o32, B, N, W, s)
               : launch_mma<false>(a32, m32, b32, o32, B, N, W, s));
  }
  const bool pow2_lanes = lanes >= 1 && lanes <= 32 &&
                          (lanes & (lanes - 1)) == 0;
  if (variant != 1 || !pow2_lanes || (vector && !vec_ok))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr decltype(&launch_rows<1>) kLaunch[] = {
      launch_rows<1>, launch_rows<2>, launch_rows<4>,
      launch_rows<8>, launch_rows<16>, launch_rows<32>};
  for (int slot = 0; slot < 6; ++slot)
    if (cols == 1 << slot)
      return static_cast<int>(kLaunch[slot](a32, m32, b32, o32, B, N, W,
                                            lanes, vector != 0, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* masked_intersect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
