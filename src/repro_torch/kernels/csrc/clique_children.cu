// The clique computation's child rows for one engine step, for Hopper
// (sm_90a):
//
//   out[m] = valid[m] ? child(states[parent[m]], action[m]) : 0   int32 [M, S]
//
// A state is laid out as repro_torch/core/clique.py lays it out (S = 2W + 2
// words): V bitset [0, W), P bitset [W, 2W), |V| at 2W, |P| at 2W + 1.  The
// child of parent row p and vertex a has V = p's V with bit a set, P = p's
// P AND ext[a] (ext = N(v) ∩ {u > v}, [N, W]), |V| = p's |V| + 1 and |P| =
// the set bits of the new P.  That is clique.py's materialize (set_bit, &,
// _pack) on the gathered parents, then the engine's where(valid, ..., 0).
//
// Replaces no TPU kernel: the JAX package computes the same rows in plain
// jnp (repro/core/clique.py's materialize under the engine's jnp.where).
// In PyTorch that expression ran as some twenty kernels over the whole
// [M, S] block (two gathers, set_bit's compare, the popcount's SWAR
// passes, a cat, a where) although only a few dozen rows a step are valid.
// This is one launch.
//
// Bound: bytes, the output written once.  On the main path (M = N =
// 46,336 selected rows, W = 1,448, S = 2,898) the block is 537 MB: 0.160
// ms at 3.35 TB/s.  Only the valid rows read anything: their parents (rows
// of the [B, S] batch, in L2) and their ext rows (5.8 KB each).
//
// Design: one warp a row.  An invalid row is stored as zeros, 16 bytes a
// lane a store: a row is 4 S bytes, a multiple of 8 but not of 16 when W is
// even, so lanes store the words before the row's first 16-byte boundary
// one word each, then the warp stores the aligned middle (512 bytes a warp
// a store), then the words after its last boundary.  A valid row is
// computed word by word, coalesced across the warp; each lane sums the
// popcount of its P words and __reduce_add_sync adds the lanes.  On the
// main path the valid rows lead (the engine selects children in descending
// priority), so the few computing warps start first and the rest of the
// grid is one stream of stores; any pattern of valid rows gives the same
// output.  A valid row whose parent or action lies outside its table traps
// (the launch's error shows at the next synchronize) rather than reading
// outside it.
//
// The weighted form (a non-null `weights`, int32 [N]: the maximum-weight
// clique computation of repro_torch/core/clique.py, whose state holds w(V)
// and w(P) where the unweighted holds |V| and |P|) shares the row walk and
// the zero fill as the template's kWeighted: w(V) + w(a) at 2W, and at
// 2W + 1 the weights of the new P's set bits below N, each lane summing
// its words' bits (__ffs, a weight read a bit, from L2: the weights are
// 185 KB at N = 46,336) before the same __reduce_add_sync.  Its bound is
// the same write.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;    // rows a block

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
clique_children_kernel(const uint32_t* __restrict__ states,
                       const int64_t* __restrict__ parent,
                       const int64_t* __restrict__ action,
                       const bool* __restrict__ valid,
                       const uint32_t* __restrict__ ext,
                       const int32_t* __restrict__ weights,
                       uint32_t* __restrict__ out, int64_t M, int64_t B,
                       int64_t N, int W) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;                  // the whole warp: one row a warp
  const int64_t S = 2 * static_cast<int64_t>(W) + 2;
  uint32_t* dst = out + row * S;

  if (!valid[row]) {
    const int head = static_cast<int>(
        ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2);
    if (lane < head) dst[lane] = 0u;
    const int64_t vectors = (S - head) >> 2;
    uint4* mid = reinterpret_cast<uint4*>(dst + head);
    for (int64_t i = lane; i < vectors; i += 32)
      mid[i] = make_uint4(0, 0, 0, 0);
    const int64_t tail = head + 4 * vectors;
    if (lane < S - tail) dst[tail + lane] = 0u;
    return;
  }

  const int64_t p = parent[row];
  const int64_t a = action[row];
  if (p < 0 || p >= B || a < 0 || a >= N) __trap();
  const uint32_t* src = states + p * S;
  const uint32_t* e = ext + a * W;
  const int bit_word = static_cast<int>(a >> 5);
  const uint32_t bit = 1u << (a & 31);
  int count = 0;        // |new P|, or its weight
  for (int j = lane; j < W; j += 32) {
    dst[j] = __ldg(src + j) | (j == bit_word ? bit : 0u);
    const uint32_t pw = __ldg(src + W + j) & __ldg(e + j);
    dst[W + j] = pw;
    if (kWeighted) {
      // bits at or above N (the last word's padding) weigh nothing
      const int64_t left = N - 32 * static_cast<int64_t>(j);
      uint32_t rest = left >= 32 ? pw
                                 : left > 0 ? pw & ((1u << left) - 1u) : 0u;
      for (; rest; rest &= rest - 1)
        count += __ldg(weights + 32 * j + __ffs(rest) - 1);
    } else {
      count += __popc(pw);
    }
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) {
    dst[2 * W] = __ldg(src + 2 * W) +
                 (kWeighted ? static_cast<uint32_t>(__ldg(weights + a)) : 1u);
    dst[2 * W + 1] = static_cast<uint32_t>(count);
  }
}

}  // namespace

// states [B, S], parent and action [M] int64, valid [M] bool, ext [N, W],
// weights [N] int32 or null (the unweighted rows), out [M, S]; S = 2W + 2,
// every tensor contiguous.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape
// the grid cannot hold.
extern "C" int clique_children_launch(const void* states, const void* parent,
                                      const void* action, const void* valid,
                                      const void* ext, const void* weights,
                                      void* out, long long M, long long B,
                                      long long N, int W, void* stream) {
  const long long blocks = (M + kWarps - 1) / kWarps;
  if (M < 1 || B < 1 || N < 1 || W < 1 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = weights != nullptr ? clique_children_kernel<true>
                                         : clique_children_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(states),
      static_cast<const int64_t*>(parent), static_cast<const int64_t*>(action),
      static_cast<const bool*>(valid), static_cast<const uint32_t*>(ext),
      static_cast<const int32_t*>(weights), static_cast<uint32_t*>(out), M, B,
      N, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* clique_children_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
