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
// Bound at the main-path shape (B = 64 dequeued states, N = 32768
// vertices, W = 1024 words): B*N*W = 2.15e9 AND+popcount word operations
// against about 143 MB of compulsory traffic (b once: 134 MB, a: 0.26 MB,
// counts: 8.4 MB).  Compute capability 9.0 retires 16 population counts
// per clock per SM (the CUDA C++ Programming Guide's arithmetic-instruction
// throughput table; AND and integer add retire at 64), so at 132 SMs and
// 1.98 GHz the popcounts alone take 0.51 ms while the bytes take 0.04 ms
// at 3.35 TB/s: the kernel is bound by __popc throughput, not by memory.
//
// The tile (simple first): each block owns a 64-row x 64-column tile of the
// output and loops over W in chunks of 32 words.  Per chunk it stages
// (a & mask) and b in shared memory, transposed so that a thread's operands
// for one word sit in one shared row; each of the 256 threads then keeps a
// 4 x 4 tile of counts in registers, so every popcount costs half a shared
// load, and the popcount pipe, not shared memory, sets the pace.  Rows and
// columns of a thread are 16 apart, which makes the column reads of a warp
// 16 consecutive words (no bank conflicts) and the row reads two broadcast
// words; the shared pitch of 65 words makes the transposing stores
// conflict-free too.  The ragged edges of B, N and W read as zero words
// and are never stored: no padding copies, unlike the TPU version.  Wider
// row tiles (so that b is read fewer times) and cp.async/TMA staging are
// later work.
//
// Two kernels, one C entry; the wrapper picks one per call in Python
// (masked_intersect.py::_plan) and passes its choice here:
//
// * the tile, masked_intersect_kernel, for every call wider than the
//   row variant's cut-over (clique and iso: N = 32,768).  Row tiles go on
//   blockIdx.y, whose grid limit is 65,535 tiles (B <= 4,194,240 rows); a
//   taller call is launched as one grid per 4,194,240 rows, each on its
//   own slice of a, mask and out.
//
// * the row-streaming variant, masked_intersect_kernel_rows, for narrow
//   calls (N at most the cut-over; the pattern edge probe is [Ep <=
//   1,024 rows] x [1 column] x [W words] with a row mask).  There the
//   tile leaves 63 of its 64 columns empty, puts one block on each of
//   Ep / 64 SMs and walks W in series: 0.23 ms at 1,024 x 1 x 1,024,
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

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// variant 0 is the tile (lanes, vector and cols unused); variant 1 the
// row-streaming kernel with `lanes` threads a row (1, 2, ..., 32), 16-byte
// loads if `vector` (W % 4 == 0 and a, mask, b 16-byte aligned), `cols`
// column sums a lane (1, 2, ..., 32).  A plan the kernels cannot run is
// refused with cudaErrorInvalidValue before anything launches.
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
  const bool pow2_lanes = lanes >= 1 && lanes <= 32 &&
                          (lanes & (lanes - 1)) == 0;
  const bool vec_ok = W % 4 == 0 && aligned16(a) && aligned16(b) &&
                      (mask == nullptr || aligned16(mask));
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
