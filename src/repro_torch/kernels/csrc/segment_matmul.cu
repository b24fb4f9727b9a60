// Segmented sum of edge messages into their destination nodes, for Hopper
// (sm_90a):
//
//     out[n] = sum over edges e with dst[e] == n of messages[e]   fp32 [N, D]
//
// messages are [E, D] fp32 or bf16, row-major; an edge whose dst lies
// outside [0, N) contributes nothing.  One C call (segment_matmul_launch)
// launches, on the caller's stream, the kernels that sort the edges by
// destination into a CSR and then the sum: the permutation `order` and the
// row pointers `ptr` ([N + 1]: the edges of node n are
// order[ptr[n] .. ptr[n+1]), in ascending edge order); edges with an
// out-of-range dst sort past ptr[N] and are never read.
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
// The sum: one thread per (node, 16-byte column chunk).  A node's threads
// sit side by side, so each message row is read as whole 16-byte accesses
// coalesced across the row (a bf16 chunk is widened to 8 floats in
// registers).  Each thread walks its node's edges in the CSR's order and
// accumulates in fp32 registers, then writes its chunk once: no atomics,
// and the sum is taken in edge order, so the result is deterministic and
// independent of the launch.  Nodes without edges write zeros (the output
// needs no separate clearing pass).  A D that is not a multiple of the
// chunk runs the one-element-per-thread instance of the same kernel.
//
// The CSR: a stable counting sort by key = dst in [0, N) ? dst : N.  It
// must read dst (4E bytes) and write ptr and order (4(N+1) + 4E): 1.7 MB,
// 0.5 us at 3.35 TB/s at the shape above, under a hundredth of the sum.  A
// device-wide library sort (CUB's DeviceRadixSort, as torch.sort runs it)
// makes several passes over 32-bit keys, allocates, and costs a host
// round of dispatch per operation; the port writes its kernels itself, and
// these use only CUB's block-level primitives (BlockRadixSort, BlockScan,
// BlockReduce) inside them.  The kernels, all launched every call (no host
// read of the data decides anything):
//   1. count (one block per tile of 2,048 edges): counts each key with
//      warp-aggregated integer atomics into the ptr buffer (counts are
//      deterministic), and each key's tile of the ptr scan likewise; sets
//      the `unsorted` flag if some key[e-1] > key[e]; counts the 8-bit
//      digits of every radix pass (the first pass's per tile).
//   2. scan (one block per 4,096 counters): exclusive scan of the N + 1
//      counts into ptr in place, each block's base the sum of the earlier
//      tiles' counts.
//   3. placement.  Sorted keys (the GraphSAGE sample's dst comes sorted):
//      order[e] = e, written by the first radix pass's blocks, and every
//      other radix kernel returns on reading the flag.  Otherwise a stable
//      LSD radix sort over the ceil(log2(N + 1)) key bits, 8 bits a pass
//      (three passes at N = 141,313): a digit-scan kernel turns the pass's
//      per-(digit, tile) counts into scatter offsets, digit-major; a place
//      kernel sorts its tile by the digit with BlockRadixSort (stable in
//      the tile's order) and scatters each edge to its digit's offset plus
//      its rank among the tile's edges of that digit, counting the next
//      pass's per-(digit, tile) histogram as it goes.
#include <cstddef>
#include <cstdint>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
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

// ------------------------------------------------------------- the CSR
constexpr int kRadixItems = 8;
constexpr int kRadixTile = kThreads * kRadixItems;   // edges a radix tile
constexpr int kScanItems = 16;
constexpr int kScanTile = kThreads * kScanItems;     // counters a scan tile
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kMaxPasses = 4;                        // 31-bit keys
constexpr uint32_t kPadKey = 0xffffffffu;            // past every real key
static_assert(kThreads == kDigits, "one thread per digit");

// The scratch buffer, in int32 elements: the part cleared each call
// (ptr's counts, the scan tiles' sums, the flag, the radix passes' digit
// totals and per-(digit, tile) histograms), then order and the two
// ping-pong buffers of keys and edge ids.  segment_matmul.py's
// _csr_layout computes the same.
struct Layout {
  int passes, tiles, scan_tiles;
  int64_t tile_sums, flag, totals, hist, zeroed, order, keys_a, vals_a,
      keys_b, vals_b, total;
};

Layout layout(int E, int N) {
  Layout L;
  int bits = 0;
  while (bits < 31 && (static_cast<int64_t>(1) << bits) <= N) ++bits;
  L.passes = (bits + kDigitBits - 1) / kDigitBits;   // N >= 1: bits >= 1
  L.tiles = static_cast<int>((static_cast<int64_t>(E) + kRadixTile - 1)
                             / kRadixTile);
  L.scan_tiles = static_cast<int>((static_cast<int64_t>(N) + kScanTile)
                                  / kScanTile);
  L.tile_sums = static_cast<int64_t>(N) + 1;            // ptr at 0
  L.flag = L.tile_sums + L.scan_tiles;
  L.totals = L.flag + 1;
  L.hist = L.totals + static_cast<int64_t>(L.passes) * kDigits;
  L.zeroed = L.hist + static_cast<int64_t>(L.passes) * kDigits * L.tiles;
  L.order = L.zeroed;
  L.keys_a = L.order + E;
  L.vals_a = L.keys_a + E;
  L.keys_b = L.vals_a + E;
  L.vals_b = L.keys_b + E;
  L.total = L.vals_b + E;
  return L;
}

__device__ __forceinline__ int key_of(int d, int N) {
  return static_cast<unsigned>(d) < static_cast<unsigned>(N) ? d : N;
}

__device__ __forceinline__ int digit_of(uint32_t key, int shift) {
  return static_cast<int>((key >> shift) & (kDigits - 1));
}

// 1. Counts of each key into counts[N + 1], of each scan tile's keys into
//    tile_sums, every pass's digit totals into totals[passes][kDigits] and
//    the first pass's per-tile digit counts into hist0[kDigits][tiles];
//    *unsorted = 1 where a key is smaller than the one before it.  Edges
//    are read striped (e = tile start + i * kThreads + thread).
__global__ void __launch_bounds__(kThreads)
csr_count_kernel(const int32_t* __restrict__ dst, int E, int N, int passes,
                 int tiles, int32_t* __restrict__ counts,
                 int32_t* __restrict__ tile_sums,
                 int32_t* __restrict__ unsorted,
                 int32_t* __restrict__ totals, int32_t* __restrict__ hist0) {
  __shared__ int s_hist[kMaxPasses][kDigits];
  for (int i = threadIdx.x; i < kMaxPasses * kDigits; i += kThreads)
    s_hist[i / kDigits][i % kDigits] = 0;
  __syncthreads();
  const unsigned lane = threadIdx.x & 31;
  int descent = 0;
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    const int64_t e = static_cast<int64_t>(blockIdx.x) * kRadixTile
                      + i * kThreads + threadIdx.x;
    const bool valid = e < E;
    const int key = valid ? key_of(dst[e], N) : -1;
    if (valid && e > 0 && key_of(dst[e - 1], N) > key) descent = 1;
    // one atomic per distinct key (and scan tile) in the warp
    unsigned same = __match_any_sync(0xffffffffu, key);
    if (valid && lane == __ffs(same) - 1)
      atomicAdd(&counts[key], __popc(same));
    const int tile = valid ? key / kScanTile : -1;
    same = __match_any_sync(0xffffffffu, tile);
    if (valid && lane == __ffs(same) - 1)
      atomicAdd(&tile_sums[tile], __popc(same));
    if (valid)
      for (int p = 0; p < passes; ++p)
        atomicAdd(&s_hist[p][digit_of(key, kDigitBits * p)], 1);
  }
  if (__syncthreads_or(descent) && threadIdx.x == 0) *unsorted = 1;
  const int d = threadIdx.x;
  for (int p = 0; p < passes; ++p) {
    const int c = s_hist[p][d];
    if (p == 0) hist0[static_cast<int64_t>(d) * tiles + blockIdx.x] = c;
    if (c) atomicAdd(&totals[p * kDigits + d], c);
  }
}

// 2. Exclusive scan of counts[0 .. count) in place (count = N + 1, so
//    ptr[N] is the number of kept edges).
__global__ void __launch_bounds__(kThreads)
csr_scan_kernel(int32_t* __restrict__ ptr, int count,
                const int32_t* __restrict__ tile_sums) {
  using Reduce = cub::BlockReduce<int, kThreads>;
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ union {
    typename Reduce::TempStorage reduce;
    typename Scan::TempStorage scan;
  } tmp;
  __shared__ int s_base;
  int before = 0;
  for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x); b += kThreads)
    before += tile_sums[b];
  before = Reduce(tmp.reduce).Sum(before);
  if (threadIdx.x == 0) s_base = before;
  __syncthreads();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kScanTile
                        + threadIdx.x * kScanItems;
  int items[kScanItems];
#pragma unroll
  for (int i = 0; i < kScanItems; ++i)
    items[i] = first + i < count ? ptr[first + i] : 0;
  Scan(tmp.scan).ExclusiveSum(items, items);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i)
    if (first + i < count) ptr[first + i] = s_base + items[i];
}

// 3a. One radix pass's scatter offsets: block d turns hist[d][0 .. tiles)
//     into the digit-major exclusive prefix (the edges of smaller digits,
//     then of digit d in earlier tiles), in place.
__global__ void __launch_bounds__(kThreads)
csr_digit_scan_kernel(int32_t* __restrict__ hist,
                      const int32_t* __restrict__ totals, int tiles,
                      const int32_t* __restrict__ unsorted) {
  if (!*unsorted) return;
  constexpr int kItems = 4;
  using Reduce = cub::BlockReduce<int, kThreads>;
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ union {
    typename Reduce::TempStorage reduce;
    typename Scan::TempStorage scan;
  } tmp;
  __shared__ int s_carry;
  const int d = blockIdx.x;
  int before = static_cast<int>(threadIdx.x) < d ? totals[threadIdx.x] : 0;
  before = Reduce(tmp.reduce).Sum(before);
  if (threadIdx.x == 0) s_carry = before;
  __syncthreads();
  int32_t* row = hist + static_cast<int64_t>(d) * tiles;
  for (int base = 0; base < tiles; base += kThreads * kItems) {
    const int first = base + threadIdx.x * kItems;
    int items[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      items[i] = first + i < tiles ? row[first + i] : 0;
    int aggregate;
    Scan(tmp.scan).ExclusiveSum(items, items, aggregate);
    const int carry = s_carry;
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (first + i < tiles) row[first + i] = carry + items[i];
    __syncthreads();
    if (threadIdx.x == 0) s_carry = carry + aggregate;
    __syncthreads();
  }
}

// 3b. One radix pass over one tile of kRadixTile edges (blocked: thread t
//     holds positions t * kRadixItems + i).  Pass 0 reads dst and makes
//     the keys; a later pass reads the previous pass's keys and edge ids.
//     The last pass writes order; an earlier one writes the next pass's
//     input and counts its per-(digit, tile) histogram.  Sorted keys: the
//     first pass writes order[e] = e, and every pass returns.
__global__ void __launch_bounds__(kThreads)
csr_place_kernel(int pass, int passes, const int32_t* __restrict__ dst,
                 int E, int N, const uint32_t* __restrict__ keys_in,
                 const int32_t* __restrict__ vals_in,
                 uint32_t* __restrict__ keys_out,
                 int32_t* __restrict__ vals_out, int32_t* __restrict__ order,
                 const int32_t* __restrict__ offsets,
                 int32_t* __restrict__ hist_next, int tiles,
                 const int32_t* __restrict__ unsorted) {
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kRadixTile;
  if (!*unsorted) {
    if (pass == 0)
#pragma unroll
      for (int i = 0; i < kRadixItems; ++i) {
        const int64_t e = tile0 + i * kThreads + threadIdx.x;
        if (e < E) order[e] = static_cast<int32_t>(e);
      }
    return;
  }
  using Sort = cub::BlockRadixSort<uint32_t, kThreads, kRadixItems, int32_t>;
  __shared__ typename Sort::TempStorage tmp;
  __shared__ unsigned char s_digit[kRadixTile];
  __shared__ int s_start[kDigits];
  uint32_t keys[kRadixItems];
  int32_t vals[kRadixItems];
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    const int64_t e = tile0 + threadIdx.x * kRadixItems + i;
    if (e >= E) {
      keys[i] = kPadKey;      // sorts after the tile's real edges
      vals[i] = -1;
    } else if (pass == 0) {
      keys[i] = static_cast<uint32_t>(key_of(dst[e], N));
      vals[i] = static_cast<int32_t>(e);
    } else {
      keys[i] = keys_in[e];
      vals[i] = vals_in[e];
    }
  }
  const int shift = pass * kDigitBits;
  Sort(tmp).Sort(keys, vals, shift, shift + kDigitBits);
  const int pos0 = threadIdx.x * kRadixItems;
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i)
    s_digit[pos0 + i] = static_cast<unsigned char>(digit_of(keys[i], shift));
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    const int pos = pos0 + i;
    if (pos == 0 || s_digit[pos - 1] != s_digit[pos])
      s_start[s_digit[pos]] = pos;
  }
  __syncthreads();
  const bool last = pass == passes - 1;
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    if (vals[i] < 0) continue;
    const int d = digit_of(keys[i], shift);
    const int dest = offsets[static_cast<int64_t>(d) * tiles + blockIdx.x]
                     + pos0 + i - s_start[d];
    if (last) {
      order[dest] = vals[i];
    } else {
      keys_out[dest] = keys[i];
      vals_out[dest] = vals[i];
      atomicAdd(&hist_next[static_cast<int64_t>(
                               digit_of(keys[i], shift + kDigitBits)) * tiles
                           + dest / kRadixTile], 1);
    }
  }
}

// Every kernel of the CSR build, on `s`: ptr at scratch[0 .. N], order at
// scratch[L.order ..].
cudaError_t build_csr(const int32_t* dst, int32_t* scratch, const Layout& L,
                      int E, int N, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(scratch, 0, L.zeroed * sizeof(int32_t), s);
  if (err != cudaSuccess) return err;
  int32_t* flag = scratch + L.flag;
  if (E > 0)
    csr_count_kernel<<<L.tiles, kThreads, 0, s>>>(
        dst, E, N, L.passes, L.tiles, scratch, scratch + L.tile_sums, flag,
        scratch + L.totals, scratch + L.hist);
  csr_scan_kernel<<<L.scan_tiles, kThreads, 0, s>>>(scratch, N + 1,
                                                    scratch + L.tile_sums);
  if (E == 0) return cudaGetLastError();
  uint32_t* keys[2] = {reinterpret_cast<uint32_t*>(scratch + L.keys_a),
                       reinterpret_cast<uint32_t*>(scratch + L.keys_b)};
  int32_t* vals[2] = {scratch + L.vals_a, scratch + L.vals_b};
  const int64_t per_pass = static_cast<int64_t>(kDigits) * L.tiles;
  for (int p = 0; p < L.passes; ++p) {
    int32_t* hist = scratch + L.hist + p * per_pass;
    csr_digit_scan_kernel<<<kDigits, kThreads, 0, s>>>(
        hist, scratch + L.totals + p * kDigits, L.tiles, flag);
    // pass p writes buffer p % 2 and reads the other
    csr_place_kernel<<<L.tiles, kThreads, 0, s>>>(
        p, L.passes, dst, E, N, keys[(p + 1) % 2], vals[(p + 1) % 2],
        keys[p % 2], vals[p % 2], scratch + L.order, hist, hist + per_pass,
        L.tiles, flag);
  }
  return cudaGetLastError();
}

}  // namespace

// The CSR of dst into `scratch` (int32, at least scratch_elems elements as
// _csr_layout sizes it), then, unless out is null, the sum of msg into out.
// dtype: 0 = fp32, 1 = bf16 messages.  Launches on `stream`, reads nothing
// back, and returns the first CUDA error (0 = launched).
extern "C" int segment_matmul_launch(const void* msg, const void* dst,
                                     void* scratch, long long scratch_elems,
                                     void* out, int E, int num_nodes, int D,
                                     int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L = layout(E, num_nodes);
  if (E < 0 || num_nodes < 1 || scratch_elems < L.total)
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t* csr = static_cast<int32_t*>(scratch);
  cudaError_t err = build_csr(static_cast<const int32_t*>(dst), csr, L, E,
                              num_nodes, s);
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);
  const int32_t* order = csr + L.order;
  const bool vectorized = vec16_ok(msg, D, dtype == 0 ? 4 : 2);
  if (dtype == 0) {
    if (vectorized) launch<float, 4>(msg, order, csr, out, num_nodes, D, s);
    else launch<float, 1>(msg, order, csr, out, num_nodes, D, s);
  } else {
    if (vectorized)
      launch<__nv_bfloat16, 8>(msg, order, csr, out, num_nodes, D, s);
    else launch<__nv_bfloat16, 1>(msg, order, csr, out, num_nodes, D, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
