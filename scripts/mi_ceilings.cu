// Ceilings for masked_intersect's tensor-core kernel, measured apart from
// it (scripts/mi_ceilings.py builds and runs this file):
//
// * wgmma_rate: back-to-back wgmma with A from registers and B from shared
//   memory, `warpgroups` warpgroups a block, one block an SM, commit
//   groups of 8 with wait_group 0 (as the kernel issues them), fragments
//   and descriptors fixed.  KIND 0 is m64n64k32.s32.u8.u8 (the count as a
//   product of 0/1 bytes, 32 bits of K a step), KIND 1 the kernel's 1-bit
//   m64n64k256.s32.b1.b1.and.popc (an AND-popcount over 256 bits of K a
//   step, packed words as they are; NVIDIA publishes no rate for it).
// * stream_kernel: b's stream as the kernel reads it: each block cp.asyncs
//   its 256 columns of W words, CW words a column a stage (16 bytes a
//   copy), two stages in flight.
//
// The 1-bit wgmma is the kernel's own (wgmma_and_popc), from its source.
#include <cstdint>

#include <cuda_runtime.h>

#include "../src/repro_torch/kernels/csrc/masked_intersect.cu"

namespace {

__device__ __forceinline__ void wgmma_u8(int32_t (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
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

constexpr int kGroup = 8;                 // wgmmas a commit group

template <int KIND>
__global__ void __launch_bounds__(384, 1) wgmma_rate(int iters, int* out) {
  extern __shared__ __align__(128) unsigned char sm[];
  for (int i = threadIdx.x; i < kGroup * 2048 / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(sm)[i] = i * 2654435761u;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  uint64_t desc[kGroup];
  for (int v = 0; v < kGroup; ++v)      // K-major, no swizzle, as the kernel
    desc[v] = static_cast<uint64_t>(((base + v * 2048) >> 4) & 0x3FFF) |
              static_cast<uint64_t>(8) << 16 | static_cast<uint64_t>(16)
                                                   << 32;
  int32_t d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0;
  const uint32_t a[4] = {threadIdx.x * 7u, threadIdx.x * 13u, ~threadIdx.x,
                         threadIdx.x};
  for (int it = 0; it < iters; ++it) {
    for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int v = 0; v < kGroup; ++v) {
      if constexpr (KIND == 0) wgmma_u8(d, a, desc[v]);
      else wgmma_and_popc(d, a, desc[v]);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
  }
  int s = 0;
  for (int i = 0; i < 32; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CW>
__global__ void __launch_bounds__(128, 1)
stream_kernel(const uint32_t* b, int W, int* out) {
  extern __shared__ __align__(128) unsigned char sm[];
  constexpr int kRing = 3, kPitch = CW + 4;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * 256;
  const int stages = W / CW;
  auto load = [&](int s) {
    if (s < stages)
      for (int i = threadIdx.x; i < 256 * CW / 4; i += 128) {
        const int c = i / (CW / 4), k = (i % (CW / 4)) * 4;
        const uint32_t dst =
            base + ((s % kRing) * 256 * kPitch + c * kPitch + k) * 4;
        const uint32_t* src = b + (col0 + c) * W + s * CW + k;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                     "l"(src)
                     : "memory");
      }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int s = 0; s < kRing - 1; ++s) load(s);
  int acc = 0;
  for (int s = 0; s < stages; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
    __syncthreads();
    acc += reinterpret_cast<const int*>(
        sm)[(s % kRing) * 256 * kPitch + threadIdx.x];
    __syncthreads();
    load(s + kRing - 1);
  }
  out[blockIdx.x * 128 + threadIdx.x] = acc;
}

}  // namespace

// kind 0 (u8) or 1 (b1); warpgroups 1 to 3; returns cudaGetLastError()
extern "C" int wgmma_rate_launch(int kind, int blocks, int warpgroups,
                                 int iters, void* out, void* stream) {
  const auto kernel = kind == 0 ? wgmma_rate<0> : wgmma_rate<1>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kGroup * 2048);
  kernel<<<blocks, 128 * warpgroups, kGroup * 2048,
           static_cast<cudaStream_t>(stream)>>>(iters,
                                                static_cast<int*>(out));
  return cudaGetLastError();
}

// cw 16 or 32 words a column a stage; N % 256 == 0, W % cw == 0, b
// 16-byte aligned
extern "C" int stream_launch(int cw, const void* b, int N, int W, void* out,
                             void* stream) {
  const auto kernel = cw == 16 ? stream_kernel<16> : stream_kernel<32>;
  const int smem = 3 * 256 * (cw + 4) * 4;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kernel<<<N / 256, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(b), W, static_cast<int*>(out));
  return cudaGetLastError();
}
