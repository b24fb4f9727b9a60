// 16-byte loads widened to fp32, shared by the kernels that copy or sum
// rows of fp32 or bf16 elements (segment_matmul.cu, embedding_bag.cu).
//
// load_f32<T, VEC>(p, x) reads VEC consecutive elements of type T at p into
// x[0..VEC) as floats: VEC = 4 fp32 or 8 bf16 is one 16-byte access (p
// 16-byte aligned), VEC = 1 one element (any alignment).  bf16 is widened
// with the intrinsics only.  vec16_ok says whether rows of D elements at
// `base` allow the 16-byte form.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* p, float* x);

template <>
__device__ __forceinline__ void load_f32<float, 4>(const float* p, float* x) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

template <>
__device__ __forceinline__ void load_f32<__nv_bfloat16, 8>(
    const __nv_bfloat16* p, float* x) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void load_f32<float, 1>(const float* p, float* x) {
  x[0] = __ldg(p);
}

template <>
__device__ __forceinline__ void load_f32<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float* x) {
  x[0] = __bfloat162float(p[0]);
}

// x[0..VEC) to out[0..VEC): float4 stores when VEC is a multiple of 4
template <int VEC>
__device__ __forceinline__ void store_f32(float* out, const float* x) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int v = 0; v < VEC; v += 4)
      *reinterpret_cast<float4*>(out + v) =
          make_float4(x[v], x[v + 1], x[v + 2], x[v + 3]);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = x[v];
  }
}

inline bool vec16_ok(const void* base, int D, int elem_bytes) {
  return D % (16 / elem_bytes) == 0 &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0;
}
