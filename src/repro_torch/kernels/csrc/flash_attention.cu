// Softmax attention with an online softmax over key/value tiles, for
// Hopper (sm_90a):
//
//     out[h] = softmax(q[h] k[h]^T / sqrt(D) [+ causal mask]) v[h]   fp32
//
// q, k, v are [H, S, D] fp32 or bf16, row-major; out is [H, S, D] fp32.
// The [S, S] scores never reach device memory.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_kernel
// (launched by flash_attention through pl.pallas_call).  There the grid is
// (head, q-tile, kv-tile) with the kv axis innermost and sequential, the
// running max, denominator and accumulator carried across grid steps in
// VMEM scratch, and causal tiles above the diagonal computed and masked.
// Hopper's blocks run in parallel and in no order, so here one block owns
// one (head, q-tile), keeps the running statistics in registers and walks
// the k/v tiles itself; under `causal` it stops at the diagonal tile, so
// the tiles above it are never loaded or computed.
//
// Bound: operations.  Causal attention takes 4*H*D*S(S+1)/2 flops (two
// products, a multiply and an add each); at the co-workload shape (Llama-3
// 8B: H = 32, S = 8192, D = 128) that is 5.5e11 flops, 8.2 ms at the
// H100's 67 TFLOP/s of fp32 FMA and 0.5559 ms at its 989 TFLOP/s of bf16
// tensor-core products, against 0.27 GB of q/k/v/out (0.08 ms at 3.35
// TB/s in fp32).
//
// fp32 (flash_attention_fma_kernel): fp32 FMA, since TF32 tensor-core
// products would break the reference's 2e-4 tolerance.  A block owns 64 q
// rows and walks 64-key tiles; the head dimension is padded with zeros to
// the template's DP (16, 32, 64, 128 or 256) and ragged S is masked, so any
// S and any D <= 256 run.  256 threads as a 16 x 16 grid; thread (ty, tx)
// owns q rows 4ty..4ty+3, score columns 4tx..4tx+3 of the tile and output
// columns tx + 16j.  The q tile (pre-multiplied by log2(e)/sqrt(D), so that
// the softmax runs on exp2) and each k tile are staged transposed in shared
// memory, so a thread reads its 4 rows and its 4 columns of one depth step
// as two float4; the probabilities go back through shared memory,
// transposed, for the P.V product, whose v reads are 16 consecutive floats.
// Row statistics are reduced over the 16 threads of a row with shuffles.
// 30 KB (DP = 16) to 217 KB (DP = 256) of dynamic shared memory.
//
// bf16 (flash_attention_wgmma_kernel): both products on wgmma, bf16 in,
// fp32 accumulate, the FlashAttention-3 layout without its warp
// specialisation.  A block owns 128 q rows of one head: 256 threads, two
// warpgroups of 64 rows each.  Its rows are DP = 64, 128 or 256 bf16 wide
// (the wrapper zero-pads a narrower D; the true D sets the scale and the
// store mask).  Shared memory holds the q tile for the whole loop and a
// 2-stage ring of k/v tiles of 128 keys (64 at DP = 256), all in the
// 128-byte swizzled layout: DP/64 panels of [rows][64], the 16-byte chunk c
// of row r stored at chunk c ^ (r % 8).  TMA writes that layout through
// 3-D tensor maps over [H, S, DP] (rows past S read as zeros, never as the
// next head's), completing a full mbarrier per stage with expect_tx bytes;
// one thread issues tile j+1's loads before tile j is multiplied, after
// both warpgroups' eight warps arrived on that stage's empty mbarrier.
// S = Q.K^T is wgmma m64nKk16 with both operands read from shared memory
// through descriptors (K-major, 32 bytes a k-step inside a panel).  The
// online softmax runs on the raw scores in the accumulator fragments (the
// row max and sum over the 4 lanes of a row; log2(e)/sqrt(D) folded into
// one FMA per score before ex2.approx), masking only the diagonal tile and
// keys >= S.  The fragments, rounded to bf16 pairs as the TPU
// kernel rounds p to v's type, are the A operand of O += P.V, wgmma with A
// in registers and the v tile as an MN-major (transposed) B; the
// denominator sums the fp32 p.  The epilogue writes O / l from registers.
// DP = 128: 32 KB of q plus 2 x 64 KB of k/v, one block per SM.
//
// Not yet: a producer warpgroup with setmaxnreg, softmax overlapped with
// the other warpgroup's products (ping-pong), skipping the masked half of
// the diagonal tile per warpgroup, a TMA store of O.
#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;              // q rows per block
constexpr int kCols = 64;              // k/v rows per tile
constexpr int kPitch = 68;             // transposed tiles: 64 + 4 floats

// ---------------------------------------------------------------- fp32
template <int DP>
constexpr size_t fma_smem_bytes() {
  // qt [DP][kPitch], kt [DP][kPitch], vs [kCols][DP], pt [kCols][kPitch]
  return sizeof(float) *
         (2 * DP * kPitch + kCols * DP + kCols * kPitch);
}

// max (or sum) over the 16 threads of one row: lanes 16k .. 16k+15
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_fma_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int S, int d,
                           float q_scale, int causal) {
  constexpr int CPT = DP / 16;         // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                    // qt[c][r] = q[q0 + r][c] * q_scale
  float* kt = qt + DP * kPitch;        // kt[c][j] = k[k0 + j][c]
  float* vs = kt + DP * kPitch;        // vs[j][c] = v[k0 + j][c]
  float* pt = vs + kCols * DP;         // pt[j][r] = p[r][j]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // the longest causal rows first, so the last wave holds the short ones
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const size_t head = static_cast<size_t>(blockIdx.y) * S * d;

  for (int idx = tid; idx < kRows * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx % DP;
    float x = 0.f;
    if (q0 + r < S && c < d)
      x = q[head + static_cast<size_t>(q0 + r) * d + c] * q_scale;
    qt[c * kPitch + r] = x;
  }

  float m[4], l[4], o[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) o[i][j] = 0.f;
  }

  const int q_end = min(q0 + kRows, S);          // one past the last row
  const int k_end = causal ? q_end : S;          // keys any row may see
  for (int k0 = 0; k0 < k_end; k0 += kCols) {
    __syncthreads();                   // the last tile's readers are done
#pragma unroll 4
    for (int idx = tid; idx < kCols * DP; idx += kThreads) {
      const int j = idx / DP;
      const int c = idx % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < S && c < d) {
        const size_t off = head + static_cast<size_t>(k0 + j) * d + c;
        kx = k[off];
        vx = v[off];
      }
      kt[c * kPitch + j] = kx;
      vs[j * DP + c] = vx;
    }
    __syncthreads();

    // scores (in log2 units) of rows 4ty+i against columns 4tx+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 a =
          *reinterpret_cast<const float4*>(&qt[c * kPitch + 4 * ty]);
      const float4 b =
          *reinterpret_cast<const float4*>(&kt[c * kPitch + 4 * tx]);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ar[i], br[j], s[i][j]);
    }
    if ((causal && k0 + kCols > q0 + 1) || k0 + kCols > S) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + 4 * tx + j;
          if (key >= S || (causal && key > q0 + 4 * ty + i))
            s[i][j] = -INFINITY;
        }
    }

    // online softmax: rescale the running sums to the new row maximum
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float tile_max = row_max(
          fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], tile_max);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // no key yet
      const float alpha = exp2f(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - base);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j) o[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(4 * tx + j) * kPitch + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kCols; ++j) {
      const float4 p =
          *reinterpret_cast<const float4*>(&pt[j * kPitch + 4 * ty]);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float x = vs[j * DP + tx + 16 * c];
        o[0][c] = fmaf(p.x, x, o[0][c]);
        o[1][c] = fmaf(p.y, x, o[1][c]);
        o[2][c] = fmaf(p.z, x, o[2][c]);
        o[3][c] = fmaf(p.w, x, o[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= S) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        out[head + static_cast<size_t>(r) * d + col] = o[i][c] * inv;
    }
  }
}

// ---------------------------------------------------------------- bf16
constexpr int kQRows = 128;            // q rows per block
constexpr int kWgmmaThreads = 256;     // two warpgroups, 64 q rows each

template <int DP>
struct Bf16Tiling {
  static constexpr int kKeys = DP == 256 ? 64 : 128;   // keys per k/v tile
  static constexpr int kQBytes = kQRows * DP * 2;
  static constexpr int kTileBytes = kKeys * DP * 2;    // one k or v tile
  static constexpr int kStageBytes = 2 * kTileBytes;   // k, then v
  // q, two stages, the mbarriers; 1 KB of slack to align the swizzle atoms
  static constexpr size_t kSmemBytes = kQBytes + 2 * kStageBytes + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x on the special-function unit (relative error about 2^-22; -inf -> 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values as one bf16x2 register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d (64 x 64, fp32) = a (64 x 16) * b (16 x 64) [+ d]; a and b from shared
// memory through their descriptors, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += a (64 x 16, bf16 pairs in registers, the
// accumulator's fragment order) * b (16 x 64); b MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, fp32) = a (64 x 16) * b (16 x 128) [+ d]; a and b from shared
// memory through their descriptors, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, fp32) += a (64 x 16, bf16 pairs in registers, the
// accumulator's fragment order) * b (16 x 128); b MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of TMA transfers
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the barrier's phase is no longer `parity`, i.e. phase number
// `parity` (mod 2) has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// rows [r, r + R) of head h as DP/64 TMA boxes of [R][64] (the map's
// 128-byte swizzle), panel after panel from dst; completes on `bar`
template <int DP, int R>
__device__ __forceinline__ void tma_rows(const CUtensorMap& map, uint32_t dst,
                                         int r, int h, uint32_t bar) {
  const uint64_t desc = reinterpret_cast<uint64_t>(&map);
#pragma unroll
  for (int p = 0; p < DP / 64; ++p)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst + p * R * 128),
        "l"(desc), "r"(64 * p), "r"(r), "r"(h), "r"(bar)
        : "memory");
}

template <int DP>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             float* __restrict__ out, int S, int d,
                             float s_scale, int causal) {
  using T = Bf16Tiling<DP>;
  constexpr int KN = T::kKeys;
  constexpr int NB = KN / 8;           // 8-key blocks of a score tile
  constexpr int OB = DP / 8;           // 8-column blocks of the output
  // the output accumulator as one wgmma's n = 64 or 128 each
  constexpr int OH = DP == 256 ? 2 : 1;
  constexpr int OW = DP / 2 / OH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs =
      smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* kv = qs + T::kQBytes;  // stage s: k, then v
  // mbarriers: full[2] (TMA bytes landed), empty[2] (8 warps done), q
  const uint32_t full0 = smem_u32(kv + 2 * T::kStageBytes);
  const uint32_t empty0 = full0 + 16;
  const uint32_t q_bar = full0 + 32;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = tid % 128 / 32;
  const int lane = tid % 32;
  const int g = lane / 4;              // fragment row (and + 8)
  const int t = lane % 4;              // fragment column pair
  // the longest causal rows first, so the last wave holds the short ones
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQRows;
  const int wg_row0 = q0 + 64 * wg;
  const int row = wg_row0 + 16 * warp + g;   // this thread's rows: +0, +8
  const size_t head = static_cast<size_t>(blockIdx.y) * S;  // first row
  const uint32_t kv_addr = smem_u32(kv);

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kWgmmaThreads / 32);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[OH][OW];                     // o[i / OW][i % OW]: as s, per 8 columns
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i / OW][i % OW] = 0.f;

  const int q_end = min(q0 + kQRows, S);         // one past the last row
  const int k_end = causal ? q_end : S;          // keys any row may see
  const int n_tiles = (k_end + KN - 1) / KN;
  if (tid == 0) {                      // q, and k/v tile 0 into stage 0
    mbar_expect_tx(q_bar, T::kQBytes);
    tma_rows<DP, kQRows>(q_map, smem_u32(qs), q0, blockIdx.y, q_bar);
    mbar_expect_tx(full0, T::kStageBytes);
    tma_rows<DP, KN>(k_map, kv_addr, 0, blockIdx.y, full0);
    tma_rows<DP, KN>(v_map, kv_addr + T::kTileBytes, 0, blockIdx.y, full0);
  }
  mbar_wait(q_bar, 0);
  // this warpgroup's 64 rows of each q panel
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * KN;
    const int stage = j & 1;
    if (tid == 0 && j + 1 < n_tiles) {
      // tile j+1 into the other stage, once tile j-1's readers left it
      const int next = stage ^ 1;
      const uint32_t dst = kv_addr + next * T::kStageBytes;
      if (j >= 1) mbar_wait(empty0 + 8 * next, ((j - 1) >> 1) & 1);
      mbar_expect_tx(full0 + 8 * next, T::kStageBytes);
      tma_rows<DP, KN>(k_map, dst, k0 + KN, blockIdx.y, full0 + 8 * next);
      tma_rows<DP, KN>(v_map, dst + T::kTileBytes, k0 + KN, blockIdx.y,
                       full0 + 8 * next);
    }
    mbar_wait(full0 + 8 * stage, (j >> 1) & 1);
    __syncwarp();                      // converged for the .aligned wgmma
    unsigned char* ks = kv + stage * T::kStageBytes;

    // scores: s[4nb + e] is (row + 8 (e >> 1), key k0 + 8nb + 2t + (e & 1))
    float s[KN / 2];
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) s[i] = 0.f;
    const uint32_t k_addr = smem_u32(ks);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = wgmma_desc(
          q_addr + (kk / 4) * kQRows * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = wgmma_desc(
          k_addr + (kk / 4) * KN * 128 + (kk % 4) * 32, 16, 1024);
      if constexpr (KN == 128) wgmma_ss_n128(s, da, db, 1);
      else wgmma_ss_n64(s, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    if ((causal && k0 + KN - 1 > wg_row0) || k0 + KN > S) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * nb + 2 * t + (e & 1);
          if (key >= S || (causal && key > row + 8 * (e >> 1)))
            s[4 * nb + e] = -INFINITY;
        }
    }

    // online softmax for rows `row` (e = 0, 1) and `row + 8` (e = 2, 3),
    // each spread over the 4 lanes of one g; m holds raw q.k scores, the
    // scale goes into each exponent's FMA
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mx = fmaxf(mx, fmaxf(s[4 * nb + 2 * hr], s[4 * nb + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      // log2 units; 0 while the row has seen no key
      const float base = m_new == -INFINITY ? 0.f : m_new * s_scale;
      const float alpha = fast_exp2(m[hr] * s_scale - base);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          s[4 * nb + e] = fast_exp2(fmaf(s[4 * nb + e], s_scale, -base));
          sum += s[4 * nb + e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * alpha + sum;
      m[hr] = m_new;
#pragma unroll
      for (int ob = 0; ob < OB; ++ob)
#pragma unroll
        for (int i = 4 * ob + 2 * hr; i < 4 * ob + 2 * hr + 2; ++i)
          o[i / OW][i % OW] *= alpha;
    }

    // o += p v: score blocks 2kk, 2kk+1 are the A fragment of keys 16kk..
    uint32_t p[KN / 16][4];
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    const uint32_t v_addr = smem_u32(ks + T::kTileBytes);
#pragma unroll
    for (int h = 0; h < OH; ++h) fence_regs(o[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < OH; ++h) {
        // 16 keys a step (two 1 KB atoms of 8 rows), panels KN * 128 B
        // apart; o[h] holds output columns 128h..
        const uint64_t db = wgmma_desc(
            v_addr + h * 2 * KN * 128 + kk * 2048, KN * 128, 1024);
        if constexpr (OW == 32) wgmma_rs_n64(o[h], p[kk], db);
        else wgmma_rs_n128(o[h], p[kk], db);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < OH; ++h) fence_regs(o[h]);
    __syncwarp();                      // the warp's reads of the stage done
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
  }

  // O / l; the output columns 8ob + 2t, +1 of rows `row` and `row + 8`
  const bool pairs = d % 2 == 0;       // float2 stores stay 8-byte aligned
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    if (r >= S) continue;
    const float inv = 1.f / l[hr];
    float* dst = out + (head + r) * d;
#pragma unroll
    for (int ob = 0; ob < OB; ++ob) {
      const int c = 8 * ob + 2 * t;
      const int i = 4 * ob + 2 * hr;
      const float x0 = o[i / OW][i % OW] * inv;
      const float x1 = o[(i + 1) / OW][(i + 1) % OW] * inv;
      if (pairs && c + 1 < d) {
        *reinterpret_cast<float2*>(dst + c) = make_float2(x0, x1);
      } else {
        if (c < d) dst[c] = x0;
        if (c + 1 < d) dst[c + 1] = x1;
      }
    }
  }
}

// ------------------------------------------------------------- launch
// log2(e) / sqrt(D): the scores come out in log2 units for exp2
inline float score_scale(int d) {
  return 1.4426950408889634f / sqrtf(static_cast<float>(d));
}

template <int DP>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        void* out, int H, int S, int d, int causal,
                        cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRows - 1) / kRows, H);
  flash_attention_fma_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, d,
      score_scale(d), causal);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &entry, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(entry);
  }
  return fn;
}

// a bf16 [H, S, DP] tensor as TMA boxes of 64 columns x `rows` rows of one
// head, 128-byte swizzled; rows past S (within the head) read as zeros
bool tensor_map(CUtensorMap* map, const void* base, int H, int S, int DP,
                int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(DP),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[2] = {2ull * DP, 2ull * DP * S};   // bytes
  const cuuint32_t box[3] = {64u, static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t step[3] = {1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int H, int S, int d, int causal,
                        cudaStream_t stream) {
  using T = Bf16Tiling<DP>;
  CUtensorMap q_map, k_map, v_map;
  if (!tensor_map(&q_map, q, H, S, DP, kQRows) ||
      !tensor_map(&k_map, k, H, S, DP, T::kKeys) ||
      !tensor_map(&v_map, v, H, S, DP, T::kKeys))
    return cudaErrorInvalidValue;
  constexpr size_t smem = T::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kQRows - 1) / kQRows, H);
  flash_attention_wgmma_kernel<DP><<<grid, kWgmmaThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<float*>(out), S, d, score_scale(d),
      causal);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: fp32 q/k/v [H, S, d] (FMA kernel), width == d;
// dtype 1: bf16 q/k/v [H, S, width] (wgmma kernel), width 64, 128 or 256,
// columns d.. zero.  1 <= d <= 256.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int H, int S,
                                      int d, int width, int causal, int dtype,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && width == d) {
    if (d <= 16) err = launch_fp32<16>(q, k, v, out, H, S, d, causal, s);
    else if (d <= 32) err = launch_fp32<32>(q, k, v, out, H, S, d, causal, s);
    else if (d <= 64) err = launch_fp32<64>(q, k, v, out, H, S, d, causal, s);
    else if (d <= 128)
      err = launch_fp32<128>(q, k, v, out, H, S, d, causal, s);
    else if (d <= 256)
      err = launch_fp32<256>(q, k, v, out, H, S, d, causal, s);
  } else if (dtype == 1 && d <= width) {
    if (width == 64) err = launch_bf16<64>(q, k, v, out, H, S, d, causal, s);
    else if (width == 128)
      err = launch_bf16<128>(q, k, v, out, H, S, d, causal, s);
    else if (width == 256)
      err = launch_bf16<256>(q, k, v, out, H, S, d, causal, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
