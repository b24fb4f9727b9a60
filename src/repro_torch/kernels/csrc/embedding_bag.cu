// Per-field embedding gather, concatenated, for Hopper (sm_90a):
//
//     out[b, f*D : (f+1)*D] = table[f, ids[b, f]]           fp32 [B, F*D]
//
// table is [F, V, D] fp32 or bf16, ids [B, F] int32, all row-major; the
// output is [B*F, D] rows in the same order as ids.  An id is taken as the
// reference's gather takes it: a negative id counts from the end of its
// field's table, and the result is clamped into [0, V), so no id reads
// outside the table.
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py::_kernel
// (launched by embedding_bag through pl.pallas_call).  There the ids are
// scalar-prefetched and the table BlockSpec's index map selects one [1, D]
// row per grid step for the pipeline to copy; here each thread loads its
// own id.
//
// Bound: memory.  At the co-workload shape (Criteo/DLRM: B = 8192 samples,
// F = 26 fields, V = 1,000,000 rows, D = 128, fp32) the gathered rows are
// 109 MB read once and the output 109 MB written once: about 0.065 ms at
// 3.35 TB/s.  The table itself (13.3 GB) is touched only at those rows.
//
// Design: one thread per (bag row, 16-byte column chunk).  The threads of
// one gathered row sit side by side, so a row is copied with whole 16-byte
// accesses, coalesced across the row (512 bytes per fp32 row at D = 128);
// a bf16 chunk is widened to 8 floats and stored as two float4.  A D that
// is not a multiple of the chunk runs the one-element-per-thread instance.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "load16.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ ids,
                     float* __restrict__ out, int64_t rows, int F, int64_t V,
                     int D) {
  const int chunks = D / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= rows * chunks) return;
  const int64_t row = t / chunks;                 // b * F + f
  const int col = static_cast<int>(t % chunks) * VEC;
  const int64_t f = row % F;
  int64_t id = __ldg(ids + row);
  if (id < 0) id += V;
  id = id < 0 ? 0 : (id >= V ? V - 1 : id);

  float x[VEC];
  load_f32<T, VEC>(table + (f * V + id) * D + col, x);
  store_f32<VEC>(out + row * D + col, x);
}

template <typename T, int VEC>
void launch(const void* table, const void* ids, void* out, int64_t rows,
            int F, int64_t V, int D, cudaStream_t stream) {
  const int64_t threads = rows * (D / VEC);
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  embedding_bag_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), rows, F, V, D);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 table; B bags of F fields.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int embedding_bag_launch(const void* table, const void* ids,
                                    void* out, int B, int F, long long V,
                                    int D, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = static_cast<int64_t>(B) * F;
  const bool vectorized = vec16_ok(table, D, dtype == 0 ? 4 : 2);
  if (dtype == 0) {
    if (vectorized) launch<float, 4>(table, ids, out, rows, F, V, D, s);
    else launch<float, 1>(table, ids, out, rows, F, V, D, s);
  } else {
    if (vectorized)
      launch<__nv_bfloat16, 8>(table, ids, out, rows, F, V, D, s);
    else launch<__nv_bfloat16, 1>(table, ids, out, rows, F, V, D, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
