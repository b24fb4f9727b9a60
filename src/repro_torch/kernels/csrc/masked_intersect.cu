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
// Both variants are this one kernel: a null mask pointer is the mask-free
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
// Design (simple first): each block owns a 64-row x 64-column tile of the
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
#include <cstddef>
#include <cstdint>

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

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int masked_intersect_launch(const void* a, const void* mask,
                                       const void* b, void* out, int B,
                                       int N, int W, void* stream) {
  const dim3 grid((N + kTileCols - 1) / kTileCols,
                  (B + kTileRows - 1) / kTileRows);
  masked_intersect_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(mask),
      static_cast<const uint32_t*>(b), static_cast<int32_t*>(out), B, N, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* masked_intersect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
