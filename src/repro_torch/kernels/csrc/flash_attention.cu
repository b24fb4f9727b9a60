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
// one (head, 64-row q-tile), keeps the running statistics in registers and
// walks the k/v tiles itself; under `causal` it stops at the diagonal
// tile, so the tiles above it are never loaded or computed.
//
// Bound: operations.  Causal attention takes 4*H*D*S(S+1)/2 flops (two
// products, a multiply and an add each); at the co-workload shape (Llama-3
// 8B: H = 32, S = 8192, D = 128) that is 5.5e11 flops, 8.2 ms at the
// H100's 67 TFLOP/s of fp32 FMA and 0.56 ms at its 989 TFLOP/s of bf16
// tensor-core products, against 0.27 GB of q/k/v/out (0.08 ms at 3.35
// TB/s in fp32).
//
// Two kernels, one per input type, on one tiling: a block owns 64 q rows
// of one head and walks 64-key tiles of k and v through shared memory; the
// head dimension is padded with zeros to the template's DP (16, 32, 64,
// 128 or 256) and ragged S is masked, so any S and any D <= 256 run.
//
// fp32 (flash_attention_fma_kernel): fp32 FMA, since TF32 tensor-core
// products would break the reference's 2e-4 tolerance.  256 threads as a
// 16 x 16 grid; thread (ty, tx) owns q rows 4ty..4ty+3, score columns
// 4tx..4tx+3 of the tile and output columns tx + 16j.  The q tile
// (pre-multiplied by log2(e)/sqrt(D), so that the softmax runs on exp2)
// and each k tile are staged transposed in shared memory, so a thread reads
// its 4 rows and its 4 columns of one depth step as two float4; the
// probabilities go back through shared memory, transposed, for the P.V
// product, whose v reads are 16 consecutive floats.  Row statistics are
// reduced over the 16 threads of a row with shuffles.  30 KB (DP = 16) to
// 217 KB (DP = 256) of dynamic shared memory.
//
// bf16 (flash_attention_mma_kernel): tensor cores through mma.sync
// m16n8k16 (bf16 in, fp32 accumulate), the FlashAttention-2 layout: 4 warps,
// each owns 16 of the 64 q rows and keeps their q fragments, running max,
// denominator and output accumulator in registers.  k and v tiles are
// staged row-major with 16-byte loads (pitch DP + 8, so fragment reads hit
// 32 distinct banks); k's B fragments are plain 32-bit shared loads, v's
// come through ldmatrix.trans.  The score fragments become the P.V
// product's A fragments in registers, rounded to bf16 as the TPU kernel
// rounds p to v's type; the denominator sums the fp32 p.  35 KB (DP = 128)
// of shared memory.
//
// Not yet: cp.async/TMA staging overlapped with compute, wgmma, and warps
// skipping their fully masked key blocks on the diagonal tile.
#include <cmath>
#include <cstddef>
#include <cstdint>

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
constexpr int kWarps = 4;              // each owns 16 of the kRows q rows
constexpr int kMmaThreads = 32 * kWarps;
static_assert(kRows == 16 * kWarps, "one m16 fragment of rows per warp");

template <int DP>
constexpr size_t mma_smem_bytes() {
  // the q tile (then each k tile) and the v tile, [kCols][DP + 8] bf16
  return sizeof(__nv_bfloat16) * 2 * kCols * (DP + 8);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two fp32 values as one bf16x2 register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment of a 16 x 8 block of a row-major [key][column] tile: lane l
// names the row of key l % 16; .trans hands each lane keys 2t, 2t+1 (and
// 2t+8, 2t+9) of column g
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
}

// rows [r0, r0 + kCols) of a row-major [S, d] matrix into dst[j][c]
// (pitch DP + 8), zero past S and past d; with 16-byte accesses when the
// rows allow them (vec16: d % 8 == 0 and 16-byte aligned operands)
template <int DP>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* src, int r0,
                                           int S, int d, bool vec16,
                                           __nv_bfloat16* dst) {
  constexpr int P = DP + 8;
  if (vec16) {
    for (int idx = threadIdx.x; idx < kCols * (DP / 8); idx += kMmaThreads) {
      const int j = idx / (DP / 8);
      const int c = idx % (DP / 8) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + j < S && c < d)
        x = __ldg(reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(r0 + j) * d + c));
      *reinterpret_cast<uint4*>(dst + j * P + c) = x;
    }
  } else {
    for (int idx = threadIdx.x; idx < kCols * DP; idx += kMmaThreads) {
      const int j = idx / DP;
      const int c = idx % DP;
      dst[j * P + c] = (r0 + j < S && c < d)
                           ? src[static_cast<size_t>(r0 + j) * d + c]
                           : __float2bfloat16(0.f);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           float* __restrict__ out, int S, int d,
                           float s_scale, int causal, bool vec16) {
  constexpr int P = DP + 8;            // pitch of the staged tiles, in bf16
  constexpr int KC = DP / 16;          // k16 steps of q.k
  constexpr int NB = kCols / 8;        // n8 blocks of a score tile
  constexpr int OB = DP / 8;           // n8 blocks of the output
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* vs = ks + kCols * P;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;              // fragment row (and + 8)
  const int t = lane % 4;              // fragment column pair
  // the longest causal rows first, so the last wave holds the short ones
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const size_t head = static_cast<size_t>(blockIdx.y) * S * d;
  const int row = q0 + 16 * warp + g;  // this thread's rows: row, row + 8

  // the warp's q rows as A fragments, kept in registers
  stage_rows<DP>(q + head, q0, S, d, vec16, ks);
  __syncthreads();
  uint32_t qf[KC][4];
  {
    const __nv_bfloat16* r = ks + (16 * warp + g) * P + 2 * t;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      qf[kc][0] = ld32(r + 16 * kc);
      qf[kc][1] = ld32(r + 8 * P + 16 * kc);
      qf[kc][2] = ld32(r + 16 * kc + 8);
      qf[kc][3] = ld32(r + 8 * P + 16 * kc + 8);
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[OB][4];
#pragma unroll
  for (int ob = 0; ob < OB; ++ob)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ob][e] = 0.f;

  const int q_end = min(q0 + kRows, S);          // one past the last row
  const int k_end = causal ? q_end : S;          // keys any row may see
  for (int k0 = 0; k0 < k_end; k0 += kCols) {
    __syncthreads();                   // q fragments / last tile read
    stage_rows<DP>(k + head, k0, S, d, vec16, ks);
    stage_rows<DP>(v + head, k0, S, d, vec16, vs);
    __syncthreads();

    // scores: s[nb] holds (row, key 8nb+2t, +1) and (row + 8, same keys)
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
      const __nv_bfloat16* kr = ks + (8 * nb + g) * P + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mma_bf16(s[nb], qf[kc], ld32(kr + 16 * kc), ld32(kr + 16 * kc + 8));
    }
    const bool masked = (causal && k0 + kCols > q0 + 1) || k0 + kCols > S;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] *= s_scale;
        const int key = k0 + 8 * nb + 2 * t + (e & 1);
        if (masked && (key >= S || (causal && key > row + 8 * (e >> 1))))
          s[nb][e] = -INFINITY;
      }

    // online softmax for rows `row` (e = 0, 1) and `row + 8` (e = 2, 3),
    // each spread over the 4 lanes of one g
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mx = fmaxf(mx, fmaxf(s[nb][2 * hr], s[nb][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // no key yet
      const float alpha = exp2f(m[hr] - base);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          s[nb][e] = exp2f(s[nb][e] - base);
          sum += s[nb][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * alpha + sum;
      m[hr] = m_new;
#pragma unroll
      for (int ob = 0; ob < OB; ++ob) {
        o[ob][2 * hr] *= alpha;
        o[ob][2 * hr + 1] *= alpha;
      }
    }

    // o += p v: score blocks 2kk, 2kk+1 are the A fragment of keys 16kk..
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = vs + (16 * kk + lane % 16) * P;
#pragma unroll
      for (int ob = 0; ob < OB; ++ob) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vr + 8 * ob);
        mma_bf16(o[ob], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    if (r >= S) continue;
    const float inv = 1.f / l[hr];
    float* dst = out + head + static_cast<size_t>(r) * d;
#pragma unroll
    for (int ob = 0; ob < OB; ++ob) {
      const int c = 8 * ob + 2 * t;
      if (c < d) dst[c] = o[ob][2 * hr] * inv;
      if (c + 1 < d) dst[c + 1] = o[ob][2 * hr + 1] * inv;
    }
  }
}

// ------------------------------------------------------------- launch
template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int H, int S, int d, int causal, int dtype,
                   cudaStream_t stream) {
  // log2(e) / sqrt(D): the scores come out in log2 units for exp2
  const float scale = 1.4426950408889634f / sqrtf(static_cast<float>(d));
  const dim3 grid((S + kRows - 1) / kRows, H);
  if (dtype == 0) {
    constexpr size_t smem = fma_smem_bytes<DP>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_fma_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_attention_fma_kernel<DP><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), S, d, scale,
        causal);
  } else {
    constexpr size_t smem = mma_smem_bytes<DP>();
    const bool vec16 = d % 8 == 0 && (reinterpret_cast<uintptr_t>(q) |
                                      reinterpret_cast<uintptr_t>(k) |
                                      reinterpret_cast<uintptr_t>(v)) %
                                             16 == 0;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_mma_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_attention_mma_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), S, d,
        scale, causal, vec16);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32 (FMA kernel), 1 = bf16 (tensor-core kernel) q/k/v;
// 1 <= d <= 256.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int H, int S,
                                      int d, int causal, int dtype,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (d <= 16) err = launch<16>(q, k, v, out, H, S, d, causal, dtype, s);
  else if (d <= 32) err = launch<32>(q, k, v, out, H, S, d, causal, dtype, s);
  else if (d <= 64) err = launch<64>(q, k, v, out, H, S, d, causal, dtype, s);
  else if (d <= 128)
    err = launch<128>(q, k, v, out, H, S, d, causal, dtype, s);
  else if (d <= 256)
    err = launch<256>(q, k, v, out, H, S, d, causal, dtype, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
