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
// 8B: H = 32, S = 8192, D = 128) that is 5.498e11 flops, 0.5559 ms at the
// H100's 989 TFLOP/s of bf16 tensor-core products.  For fp32 inputs every
// product runs as three tf32 products (below): 3.332 ms at 495 TFLOP/s of
// tf32, against 8.206 ms at 67 TFLOP/s of fp32 FMA.  Either way far above
// the 0.27 GB of q/k/v/out (0.08 ms at 3.35 TB/s in fp32).
//
// fp32 (flash_attention_tf32_kernel): both products on the tensor cores
// as split 3xTF32 wgmma.  Each fp32 operand x is split into hi = tf32(x)
// (cvt.rna) and lo = tf32(x - hi) (x - hi is exact in fp32), and each
// product becomes hi.hi + hi.lo + lo.hi accumulated in fp32, lo.lo
// dropped: about 3 * 2^-22 = 7e-7 relative error a product, against fp32's
// 6e-8 and one tf32 product's 5e-4 (which breaks the 1e-4 per-head limit
// of the smoke run).  A tf32 wgmma reads both operands K-major (the
// transpose bits exist only for 16-bit types): q [rows][D] and k [keys][D]
// are, v [keys][D] as the B of P.V is not.  So a split pass
// (tf32_split_kernel) first writes q hi/lo, k hi/lo as [H, S, DP] and
// v^T hi/lo as [H, DP, S8] into the wrapper's work buffer (≈ 1.2 GB of
// traffic at the Llama shape, ≈ 0.36 ms at 3.35 TB/s); v^T's keys are
// stored in the order 0, 2, 4, 6, 1, 3, 5, 7 within each 8, so that the
// score accumulator's registers (keys 2t, 2t + 1 of each 8-key block) are
// the tf32 A fragment of P.V (k-indices t, t + 4) as they stand, and p is
// split in registers.  A block owns 64 q rows per warpgroup: two
// warpgroups (128 rows) at DP = 32, 64 and 128, one at DP = 256.  Shared
// memory holds q hi and lo for the whole loop and a ring of chunk slots;
// a chunk is one of k hi, k lo, v^T hi, v^T lo of a k/v tile of KN keys,
// loaded by TMA (3-D tensor maps, 128-byte swizzle: a fp32 row splits into
// panels of 32 columns, a k-step of 8 tf32 is 32 bytes, so the K-major
// descriptors step +32 B inside a panel as in bf16) on the slot's full
// mbarrier; thread 0 reloads a slot once all warps arrived on its empty
// mbarrier.  DP = 128: 2 x 64 KB of q plus 3 slots of 32 KB (64-key
// tiles) = 224 KB, one block per SM; DP = 256: 2 x 64 KB of q (64 rows)
// plus 3 slots of 32 KB (32-key tiles); DP = 32, 64: 8 slots.  Both chunks
// of a product are waited for before its first wgmma (a wait between the
// wgmmas of one group makes ptxas serialize them).  The online softmax and
// the epilogue are the bf16 kernel's: raw scores, the scale folded into one
// FMA before ex2.approx, O / l written from registers; the denominator
// sums the fp32 p.  Each tile's P.V goes into a zeroed accumulator, part
// by part of the output columns (two parts of 64 at DP = 128), which is
// then added to O in fp32: accumulated across all tiles in the tensor
// core, O came out 2.3e-4 from float64 on a head of repeated-token rows of
// up to 8,192 keys (the plain version: 2.7e-5), per tile 5.3e-6.  q's
// shared-memory addresses are made opaque each tile, so that its
// descriptors are not hoisted into registers: DP = 128 then takes 220
// registers and does not spill (DP = 256, one warpgroup with 128
// registers of O, spills).  The wrapper pads nothing: the split pass
// zero-fills the columns d.. DP (_fp32_plan picks DP), and the true D sets
// the scale and the store mask.
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
// Not yet, in either kernel: a producer warpgroup with setmaxnreg,
// softmax overlapped with the other warpgroup's products (ping-pong),
// skipping the masked half of the diagonal tile per warpgroup, a TMA store
// of O.
#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// ---------------------------------------------------------------- fp32
// tf32 helpers and wgmma forms (k = 8: 8 tf32 values, 32 bytes a k-step)

// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero),
// as fp32 bits with the low 13 bits zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo + (x - hi - lo): hi = tf32(x); x - hi is exact in fp32 and
// lo = tf32(x - hi), so |x - hi - lo| <= 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  const uint32_t h = to_tf32(x);
  hi = __uint_as_float(h);
  lo = __uint_as_float(to_tf32(x - hi));
}

// d (64 x 32, fp32) += a (64 x 8) * b (8 x 32), tf32; a and b from shared
// memory through their descriptors, both K-major
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, fp32) += a (64 x 8) * b (8 x 64), tf32; a and b from shared
// memory through their descriptors, both K-major
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 32, fp32) += a (64 x 8, tf32 in registers) * b (8 x 32); b from
// shared memory through its descriptor, K-major
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, fp32) += a (64 x 8, tf32 in registers) * b (8 x 64); b from
// shared memory through its descriptor, K-major
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, fp32) += a (64 x 8, tf32 in registers) * b (8 x 128); b from
// shared memory through its descriptor, K-major
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

// position p of each group of 8 keys in the v^T tiles holds key
// key_at(p): 0, 2, 4, 6, 1, 3, 5, 7.  The tf32 A fragment gives a thread
// k-indices t and t + 4 of a k-step, the score accumulator keys 2t and
// 2t + 1 of an 8-key block; in this order they are the same p values.
__device__ __forceinline__ int key_at(int p) {
  return (p & ~7) + ((p & 4) ? 2 * (p & 3) + 1 : 2 * (p & 3));
}

constexpr int kSplitCols = 32;       // split pass: 32 keys x 32 columns
constexpr int kSplitRows = 8;        // a block of 32 x 8 threads

// The split pass: q, k, v [H, S, d] fp32 -> the tf32 operands of the
// attention kernel, in `work`: q hi, q lo, k hi, k lo as [H, S, DP] (columns
// d.. zero), then v^T hi, v^T lo as [H, DP, S8] (S8 = S rounded up to 8;
// keys in key_at order within each 8, keys >= S and columns >= d zero).
// Grid (S8 / 32 rounded up, DP / 32, H).
__global__ void __launch_bounds__(kSplitCols * kSplitRows)
tf32_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ work,
                  int H, int S, int S8, int d, int DP) {
  __shared__ float tile[kSplitCols][kSplitCols + 1];   // v[key][column]
  const int h = blockIdx.z;
  const int s0 = blockIdx.x * kSplitCols;
  const int c0 = blockIdx.y * kSplitCols;
  const int tx = threadIdx.x;
  const size_t plane = static_cast<size_t>(H) * S * DP;
  float* q_hi = work;
  float* k_hi = work + 2 * plane;
  float* vt_hi = work + 4 * plane;
  const size_t vt_plane = static_cast<size_t>(H) * DP * S8;
  const int c = c0 + tx;
  for (int r = threadIdx.y; r < kSplitCols; r += kSplitRows) {
    const int s = s0 + r;
    float qx = 0.f, kx = 0.f, vx = 0.f;
    if (s < S && c < d) {
      const size_t off = (static_cast<size_t>(h) * S + s) * d + c;
      qx = q[off];
      kx = k[off];
      vx = v[off];
    }
    tile[r][tx] = vx;
    if (s < S) {
      const size_t off = (static_cast<size_t>(h) * S + s) * DP + c;
      split_tf32(qx, q_hi[off], q_hi[plane + off]);
      split_tf32(kx, k_hi[off], k_hi[plane + off]);
    }
  }
  __syncthreads();
  const int p = s0 + tx;                 // position along the v^T row
  if (p >= S8) return;
  const int key = key_at(tx);            // within this block's 32 keys
  for (int r = threadIdx.y; r < kSplitCols; r += kSplitRows) {
    const size_t off = (static_cast<size_t>(h) * DP + c0 + r) * S8 + p;
    split_tf32(tile[key][r], vt_hi[off], vt_hi[vt_plane + off]);
  }
}

template <int DP, int NWG, int KN, int SLOTS>
struct Tf32Tiling {
  static constexpr int kRows = 64 * NWG;                // q rows per block
  static constexpr int kThreads = 128 * NWG;
  static constexpr int kQBytes = kRows * DP * 4;        // q hi or q lo
  // one chunk: a tile's k hi, k lo, v^T hi or v^T lo (KN keys x DP)
  static constexpr int kChunkBytes = KN * DP * 4;
  // q hi and lo, the ring, full[] and empty[] mbarriers and the q one; 1 KB
  // of slack to align the swizzle atoms
  static constexpr size_t kSmemBytes =
      2 * kQBytes + SLOTS * kChunkBytes + 8 * (2 * SLOTS + 1) + 1024;
  static_assert(DP % 32 == 0 && KN % 32 == 0, "whole 128-byte panels");
  static_assert(kSmemBytes <= 232448, "more than a block's shared memory");
};

// a 3-D TMA box into shared memory at dst (the map's 128-byte swizzle),
// completing on `bar`
__device__ __forceinline__ void tma_box(const CUtensorMap& map, uint32_t dst,
                                        int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

struct Tf32Maps {
  CUtensorMap q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo;
};

// chunk c = 4j + part of k/v tile j (part 0 k hi, 1 k lo, 2 v^T hi, 3 v^T
// lo) into ring slot c % SLOTS, completing on that slot's full mbarrier
template <int DP, int KN, int SLOTS>
__device__ __forceinline__ void tf32_issue(const Tf32Maps& maps,
                                           uint32_t ring, uint32_t full0,
                                           int c, int head) {
  constexpr int kChunkBytes = KN * DP * 4;
  const int slot = c % SLOTS;
  const uint32_t dst = ring + slot * kChunkBytes;
  const uint32_t bar = full0 + 8 * slot;
  const int k0 = c / 4 * KN;
  mbar_expect_tx(bar, kChunkBytes);
  if (c % 4 < 2) {                     // k rows: DP / 32 panels [KN][32]
    const CUtensorMap& map = c % 4 ? maps.k_lo : maps.k_hi;
    for (int p = 0; p < DP / 32; ++p)
      tma_box(map, dst + p * KN * 128, 32 * p, k0, head, bar);
  } else {                             // v^T rows: KN / 32 panels [DP][32]
    const CUtensorMap& map = c % 4 == 3 ? maps.vt_lo : maps.vt_hi;
    for (int p = 0; p < KN / 32; ++p)
      tma_box(map, dst + p * DP * 128, k0 + 32 * p, 0, head, bar);
  }
}

// fp32 attention on the tensor cores, both products as three tf32 wgmma
// products (hi.hi + hi.lo + lo.hi).  NWG warpgroups of 64 q rows each;
// thread 0 also loads q hi/lo once and then, tile after tile, the chunks
// k hi, k lo, v^T hi, v^T lo through a ring of SLOTS chunk slots.
// o (64 x N) += a (p, tf32 in registers) * b (v^T, K-major) for n = N
template <int N>
__device__ __forceinline__ void pv(float (&d)[N / 2], const uint32_t (&a)[4],
                                   uint64_t b) {
  if constexpr (N == 32) wgmma_tf32_rs_n32(d, a, b);
  else if constexpr (N == 64) wgmma_tf32_rs_n64(d, a, b);
  else wgmma_tf32_rs_n128(d, a, b);
}

template <int DP, int NWG, int KN, int SLOTS, int NP>
__global__ void __launch_bounds__(Tf32Tiling<DP, NWG, KN, SLOTS>::kThreads, 1)
flash_attention_tf32_kernel(const __grid_constant__ Tf32Maps maps,
                            float* __restrict__ out, int S, int d,
                            float s_scale, int causal) {
  using T = Tf32Tiling<DP, NWG, KN, SLOTS>;
  constexpr int NB = KN / 8;           // 8-key blocks of a score tile
  constexpr int KQ = DP / 8;           // k-steps of Q.K^T
  constexpr int OB = DP / 8;           // 8-column blocks of the output
  // the output accumulator as NP parts of PW columns, a wgmma of n = PW each
  constexpr int PW = DP / NP;
  constexpr int OW = PW / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs =
      smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  const uint32_t q_hi = smem_u32(qs);  // q lo follows at + kQBytes
  const uint32_t ring = q_hi + 2 * T::kQBytes;
  const uint32_t full0 = ring + SLOTS * T::kChunkBytes;
  const uint32_t empty0 = full0 + 8 * SLOTS;
  const uint32_t q_bar = empty0 + 8 * SLOTS;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int head = blockIdx.y;
  // the longest causal rows first, so the last wave holds the short ones
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::kRows;
  const int q_end = min(q0 + T::kRows, S);       // one past the last row
  const int k_end = causal ? q_end : S;          // keys any row may see
  const int n_tiles = (k_end + KN - 1) / KN;

  if (tid == 0) {
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, T::kThreads / 32);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 loads: q hi/lo once, then chunk c = 4j + part of tile j
  // (part 0 k hi, 1 k lo, 2 v^T hi, 3 v^T lo) into slot c % SLOTS
  const int n_chunks = 4 * n_tiles;
  if (tid == 0) {
    mbar_expect_tx(q_bar, 2 * T::kQBytes);
    for (int p = 0; p < DP / 32; ++p) {
      const uint32_t dst = q_hi + p * T::kRows * 128;
      tma_box(maps.q_hi, dst, 32 * p, q0, head, q_bar);
      tma_box(maps.q_lo, dst + T::kQBytes, 32 * p, q0, head, q_bar);
    }
    for (int c = 0; c < SLOTS && c < n_chunks; ++c)
      tf32_issue<DP, KN, SLOTS>(maps, ring, full0, c, head);
  }

  const int wg = tid / 128;
  const int warp = tid % 128 / 32;
  const int g = lane / 4;              // fragment row (and + 8)
  const int t = lane % 4;              // fragment column pair
  const int wg_row0 = q0 + 64 * wg;
  const int row = wg_row0 + 16 * warp + g;   // this thread's rows: +0, +8

  auto acquire = [&](int c) {          // chunk c has landed; its address
    mbar_wait(full0 + 8 * (c % SLOTS), (c / SLOTS) & 1);
    __syncwarp();                      // converged for the .aligned wgmma
    return ring + (c % SLOTS) * T::kChunkBytes;
  };
  // this warp's reads of chunk c are done; once all warps' are, thread 0
  // loads chunk c + SLOTS into its slot
  auto release = [&](int c) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (c % SLOTS));
    if (tid == 0 && c + SLOTS < n_chunks) {
      mbar_wait(empty0 + 8 * (c % SLOTS), (c / SLOTS) & 1);
      tf32_issue<DP, KN, SLOTS>(maps, ring, full0, c + SLOTS, head);
    }
  };
  // this warpgroup's 64 rows of q hi (q lo at + kQBytes), k-step kk
  auto q_desc = [&](uint32_t base, int kk) {
    return wgmma_desc(base + wg * 64 * 128 + (kk / 4) * T::kRows * 128 +
                          (kk % 4) * 32, 16, 1024);
  };
  auto k_desc = [&](uint32_t base, int kk) {
    return wgmma_desc(base + (kk / 4) * KN * 128 + (kk % 4) * 32, 16, 1024);
  };
  // v^T rows PW h.. (output columns), keys 8kb..8kb+7
  auto v_desc = [&](uint32_t base, int kb, int h) {
    return wgmma_desc(base + (kb / 4) * DP * 128 + h * PW * 128 +
                          (kb % 4) * 32, 16, 1024);
  };
  auto qk = [&](float (&s)[KN / 2], uint32_t a, uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      if constexpr (KN == 64)
        wgmma_tf32_ss_n64(s, q_desc(a, kk), k_desc(b, kk));
      else
        wgmma_tf32_ss_n32(s, q_desc(a, kk), k_desc(b, kk));
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NP][OW];                     // o[i / OW][i % OW]: as s, per 8 columns
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i / OW][i % OW] = 0.f;

  const uint32_t q_lo = q_hi + T::kQBytes;
  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * KN;
    const int c = 4 * j;

    // scores: s[4nb + e] is (row + 8 (e >> 1), key k0 + 8nb + 2t + (e & 1));
    // q.k as q_hi.k_hi + q_lo.k_hi + q_hi.k_lo
    float s[KN / 2];
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) s[i] = 0.f;
    // both chunks before the first wgmma: a wait between the products of
    // one group would make ptxas serialize them
    const uint32_t k_hi = acquire(c);
    const uint32_t k_lo = acquire(c + 1);
    // q's addresses made opaque each tile, so that its 2 DP / 8
    // descriptors are rebuilt here and not held in registers across tiles
    uint32_t qh = q_hi, ql = q_lo;
    asm volatile("" : "+r"(qh), "+r"(ql));
    fence_regs(s);
    wgmma_fence();
    qk(s, qh, k_hi);
    qk(s, ql, k_hi);
    qk(s, qh, k_lo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    release(c);
    release(c + 1);

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

    // o += p v as p_hi.v_hi + p_lo.v_hi + p_hi.v_lo.  Score block kb is the
    // A fragment of k-step kb: (row, t), (row + 8, t), (row, t + 4),
    // (row + 8, t + 4) are keys 2t, 2t, 2t + 1, 2t + 1 (key_at order)
    uint32_t p_hi[NB][4], p_lo[NB][4];
#pragma unroll
    for (int kb = 0; kb < NB; ++kb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[4 * kb + (i >> 1) + 2 * (i & 1)];
        p_hi[kb][i] = to_tf32(x);
        p_lo[kb][i] = to_tf32(x - __uint_as_float(p_hi[kb][i]));
      }
    const uint32_t v_hi = acquire(c + 2);
    const uint32_t v_lo = acquire(c + 3);
    // output columns part by part, PW at a time: each part's sum over this
    // tile goes into a zeroed accumulator f, then into o by fp32 adds.  The
    // tensor core's accumulation chain thus spans one tile, not the whole
    // row: over up to 8,192 keys of repeated (Zipf) tokens, one long chain
    // put the kernel 2.3e-4 from float64, where the plain version is 2.7e-5
#pragma unroll
    for (int h = 0; h < NP; ++h) {
      float f[PW / 2];
#pragma unroll
      for (int i = 0; i < PW / 2; ++i) f[i] = 0.f;
      fence_regs(f);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < NB; ++kb) {
        pv<PW>(f, p_hi[kb], v_desc(v_hi, kb, h));
        pv<PW>(f, p_lo[kb], v_desc(v_hi, kb, h));
        pv<PW>(f, p_hi[kb], v_desc(v_lo, kb, h));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(f);
#pragma unroll
      for (int i = 0; i < PW / 2; ++i) o[h][i] += f[i];
    }
    release(c + 2);
    release(c + 3);
  }

  // O / l; the output columns 8ob + 2t, +1 of rows `row` and `row + 8`
  const bool pairs = d % 2 == 0;       // float2 stores stay 8-byte aligned
  const size_t head_row = static_cast<size_t>(head) * S;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    if (r >= S) continue;
    const float inv = 1.f / l[hr];
    float* dst = out + (head_row + r) * d;
#pragma unroll
    for (int ob = 0; ob < OB; ++ob) {
      const int col = 8 * ob + 2 * t;
      const int i = 4 * ob + 2 * hr;
      const float x0 = o[i / OW][i % OW] * inv;
      const float x1 = o[(i + 1) / OW][(i + 1) % OW] * inv;
      if (pairs && col + 1 < d) {
        *reinterpret_cast<float2*>(dst + col) = make_float2(x0, x1);
      } else {
        if (col < d) dst[col] = x0;
        if (col + 1 < d) dst[col + 1] = x1;
      }
    }
  }
}

// ------------------------------------------------------------- launch
// log2(e) / sqrt(D): the scores come out in log2 units for exp2
inline float score_scale(int d) {
  return 1.4426950408889634f / sqrtf(static_cast<float>(d));
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

// an fp32 [H, R, C] tensor as TMA boxes of 32 columns x `rows` rows of one
// head, 128-byte swizzled; rows past R (within the head) read as zeros
bool tensor_map_f32(CUtensorMap* map, const float* base, int H, int R, int C,
                    int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(R),
                              static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[2] = {4ull * C, 4ull * C * R};   // bytes
  const cuuint32_t box[3] = {32u, static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t step[3] = {1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the split pass into `work`, then the tensor-core kernel
template <int DP, int NWG, int KN, int SLOTS, int NP>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        void* out, void* work, int H, int S, int d,
                        int causal, cudaStream_t stream) {
  using T = Tf32Tiling<DP, NWG, KN, SLOTS>;
  const int S8 = (S + 7) / 8 * 8;
  float* w = static_cast<float*>(work);
  const size_t plane = static_cast<size_t>(H) * S * DP;
  const size_t vt_plane = static_cast<size_t>(H) * DP * S8;
  Tf32Maps maps;
  if (!tensor_map_f32(&maps.q_hi, w, H, S, DP, T::kRows) ||
      !tensor_map_f32(&maps.q_lo, w + plane, H, S, DP, T::kRows) ||
      !tensor_map_f32(&maps.k_hi, w + 2 * plane, H, S, DP, KN) ||
      !tensor_map_f32(&maps.k_lo, w + 3 * plane, H, S, DP, KN) ||
      !tensor_map_f32(&maps.vt_hi, w + 4 * plane, H, DP, S8, DP) ||
      !tensor_map_f32(&maps.vt_lo, w + 4 * plane + vt_plane, H, DP, S8, DP))
    return cudaErrorInvalidValue;
  const dim3 split_grid((S8 + kSplitCols - 1) / kSplitCols, DP / kSplitCols,
                        H);
  tf32_split_kernel<<<split_grid, dim3(kSplitCols, kSplitRows), 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), w, H, S, S8, d, DP);
  constexpr size_t smem = T::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tf32_kernel<DP, NWG, KN, SLOTS, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + T::kRows - 1) / T::kRows, H);
  flash_attention_tf32_kernel<DP, NWG, KN, SLOTS, NP>
      <<<grid, T::kThreads, smem, stream>>>(maps, static_cast<float*>(out), S,
                                            d, score_scale(d), causal);
  return cudaGetLastError();
}

// the fp32 kernel's tiling by row width: <DP, q rows / 64, keys a tile,
// ring slots, parts of the P.V accumulator>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        void* out, void* work, int H, int S, int d, int width,
                        int causal, cudaStream_t s) {
  switch (width) {
    case 32:
      return launch_tf32<32, 2, 64, 8, 1>(q, k, v, out, work, H, S, d,
                                          causal, s);
    case 64:
      return launch_tf32<64, 2, 64, 8, 1>(q, k, v, out, work, H, S, d,
                                          causal, s);
    case 128:
      return launch_tf32<128, 2, 64, 3, 2>(q, k, v, out, work, H, S, d,
                                           causal, s);
    case 256:
      return launch_tf32<256, 1, 32, 3, 4>(q, k, v, out, work, H, S, d,
                                           causal, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype 0: fp32 q/k/v [H, S, d]; `width` (32, 64, 128 or 256, >= d) is the
// tf32 kernel's row width and `work` holds 4 H S width + 2 H width S8
// floats (S8 = S rounded up to 8) for its split operands.
// dtype 1: bf16 q/k/v [H, S, width] (wgmma kernel), width 64, 128 or 256,
// columns d.. zero; `work` unused.  1 <= d <= 256.  Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* work,
                                      int H, int S, int d, int width,
                                      int causal, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && d <= width) {
    err = launch_fp32(q, k, v, out, work, H, S, d, width, causal, s);
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
