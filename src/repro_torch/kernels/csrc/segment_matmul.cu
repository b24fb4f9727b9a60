// Segmented sum of edge messages into their destination nodes, for Hopper
// (sm_90a):
//
//     out[n] = sum over edges e with dst[e] == n of messages[e]   fp32 [N, D]
//
// messages are [E, D] fp32 or bf16, row-major; an edge whose dst lies
// outside [0, N) contributes nothing.  The wrapper sorts the edges by dst
// (stable) and passes the permutation `order` and the row pointers `ptr`
// ([N + 1]: the edges of node n are order[ptr[n] .. ptr[n+1]) ); edges with
// an out-of-range dst sort past ptr[N] and are never read.
//
// Replaces the TPU kernel repro/kernels/segment_matmul.py::_kernel
// (launched by segment_matmul through pl.pallas_call).  That kernel turns
// the scatter into dense MXU products: for each 128-node x 256-edge tile it
// builds a one-hot [bN, bE] matrix and multiplies it by the messages,
// N*E*D/128 times the work the sum needs.  Hopper has no reason to pay
// that: the sum is one add per message element.
//
// Bound: memory.  At the co-workload shape (GraphSAGE 2-hop sample, E =
// 140,800 edges, N = 141,313 nodes, D = 256) the messages are read once
// (144 MB in fp32, 72 MB in bf16) and the output written once (145 MB):
// 0.086 ms in fp32 at 3.35 TB/s against E*D = 36e6 adds.
//
// Design: one thread per (node, 16-byte column chunk).  A node's threads
// sit side by side, so each message row is read as whole 16-byte accesses
// coalesced across the row (a bf16 chunk is widened to 8 floats in
// registers).  Each thread walks its node's edges in the sorted order and
// accumulates in fp32 registers, then writes its chunk once: no atomics,
// and the sum is taken in edge order, so the result is deterministic and
// independent of the launch.  Nodes without edges write zeros (the output
// needs no separate clearing pass).  A D that is not a multiple of the
// chunk runs the one-element-per-thread instance of the same kernel.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "load16.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
segment_matmul_kernel(const T* __restrict__ msg,
                      const int32_t* __restrict__ order,
                      const int32_t* __restrict__ ptr,
                      float* __restrict__ out, int num_nodes, int D) {
  const int chunks = D / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(num_nodes) * chunks) return;
  const int node = static_cast<int>(t / chunks);
  const int col = static_cast<int>(t % chunks) * VEC;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  const int end = ptr[node + 1];
#pragma unroll 4
  for (int i = ptr[node]; i < end; ++i) {
    float x[VEC];
    load_f32<T, VEC>(msg + static_cast<size_t>(order[i]) * D + col, x);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] += x[v];
  }
  store_f32<VEC>(out + static_cast<size_t>(node) * D + col, acc);
}

template <typename T, int VEC>
void launch(const void* msg, const void* order, const void* ptr, void* out,
            int num_nodes, int D, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(num_nodes) * (D / VEC);
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  segment_matmul_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(msg), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(ptr), static_cast<float*>(out), num_nodes,
      D);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 messages.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int segment_matmul_launch(const void* msg, const void* order,
                                     const void* ptr, void* out,
                                     int num_nodes, int D, int dtype,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vectorized = vec16_ok(msg, D, dtype == 0 ? 4 : 2);
  if (dtype == 0) {
    if (vectorized) launch<float, 4>(msg, order, ptr, out, num_nodes, D, s);
    else launch<float, 1>(msg, order, ptr, out, num_nodes, D, s);
  } else {
    if (vectorized)
      launch<__nv_bfloat16, 8>(msg, order, ptr, out, num_nodes, D, s);
    else launch<__nv_bfloat16, 1>(msg, order, ptr, out, num_nodes, D, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
