// Segmented sum of edge messages into their destination nodes, for Hopper
// (sm_90a):
//
//     out[n] = sum over edges e with dst[e] == n of messages[e]   fp32 [N, D]
//
// messages are [E, D] fp32 or bf16, row-major; an edge whose dst lies
// outside [0, N) contributes nothing.  One C call (segment_matmul_launch)
// makes one cooperative launch of one persistent kernel on the caller's
// stream: it sorts the edges by destination into a CSR and then sums.  The
// CSR is the permutation `order` and the row pointers `ptr` ([N + 1]: the
// edges of node n are order[ptr[n] .. ptr[n+1]), in ascending edge order);
// edges with an out-of-range dst sort past ptr[N] and are never read.
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
// 0.0864 ms in fp32 and 0.0649 ms in bf16 at 3.35 TB/s, against E*D =
// 36e6 adds.
//
// What held the earlier design back (0.2309 ms fp32, 0.1974 bf16 a call
// at the shape above, of it 0.12 ms on the card; PERF.md), and what this
// one does about it:
//   - Ten device operations a call: a memset of the scratch, a count, a
//     scan, per radix pass a digit scan and a place kernel, the sum.  With
//     dst sorted, as the GraphSAGE sample's is, six of them only read the
//     `unsorted` flag and returned, and the CSR still took 0.022 ms of the
//     card for 1.7 MB.  The host's enqueue of the ten took about as long as
//     the card's work.  Now one cooperative launch (cudaLaunchCooperative
//     Kernel, as many blocks as fit on the card at once, counted once per
//     device) runs every phase, separated by grid-wide barriers
//     (cooperative_groups' grid sync):
//       (a) each 2,048-edge tile's sortedness word; clear the counters;
//       (b) sorted keys (the flags' OR, read on the card): ptr and order
//           straight from the keys, and on to the sum.  Unsorted: count;
//       (c) scan the counts into ptr; the first radix pass's digit scans;
//       (d) per radix pass: the tiles' digit counts (from the second pass
//           on), the digit scans, the place step;
//       (e) the sum.
//     Sorted keys cross two barriers, unsorted ones ten.
//   - The sum ran one thread per (node, 16-byte chunk): one 16-byte load in
//     flight a thread, ahead of two 16-byte stores in bf16, and most threads
//     only wrote zeros (13,312 of the 141,313 nodes receive edges); bf16 ran
//     at 62% of its bytes bound.  Now it runs in two passes, so that every
//     warp first reads an equal share of the rows and then writes an equal
//     share of the empty rows (split by nodes alone, the warps with rows to
//     read finish long after those with only zeros to write).  The rows
//     pass: each warp sums the nodes of an equal share of the kept rows (a
//     32-way search of ptr finds the share's first node). It streams those message rows, in CSR order, through its
//     slots of the block's ring in shared memory with bulk asynchronous copies
//     (cp.async.bulk, completing on one mbarrier a slot): one copy a slot when
//     the keys are sorted and a row fits the slot (its rows are contiguous),
//     else one copy a row through `order`.  The block's 32 slots of 2 KB go to
//     its warps that have rows, in equal parts: 8 KB or more in flight a warp.
//     Lanes read four columns at a time of each row from shared memory and add
//     them in fp32 registers, in edge order, so the result is the same bit for
//     bit as any launch's and as the earlier kernel's; each node's sum goes
//     out as 16-byte stores. Rows wider than 256 columns are summed 256
//     columns at a time.  The zeros pass: each warp takes an equal share of
//     the nodes and writes each run of empty nodes' output rows as one span of
//     16-byte stores (faster than bulk stores of zeros from shared memory); no
//     lane waits on a load for an empty node.  A D whose rows are not 16-byte
//     multiples, or messages not 16-byte aligned, take the one-element path:
//     the same passes, lanes over columns, loads and stores straight from
//     device memory.
//   - The CSR phases' shared memory (CUB's BlockRadixSort storage among
//     it) and the sum's ring share one dynamic shared-memory union, and the
//     grid is sized from it: two blocks of 256 threads an SM.
//
// The CSR: a stable counting sort by key = dst in [0, N) ? dst : N.  It
// must read dst (4E bytes) and write ptr and order (4(N+1) + 4E): 1.7 MB,
// 0.5 us at 3.35 TB/s at the shape above.  The port writes its kernels
// itself and uses only CUB's block-level BlockRadixSort inside them.  The
// phases' work:
//   (a) per tile: 1 if some key is smaller than the one before it.
//   (b) sorted: ptr[n] = the first edge with key >= n, written over each
//       gap between consecutive keys; order[e] = e.  Unsorted, per tile:
//       each key counted with integer atomics (one for the warp when its
//       32 keys agree), each key's scan tile likewise (in shared memory
//       first), the 8-bit digits of every radix pass (the first pass's per
//       tile).
//   (c) per 4,096 counters: exclusive scan into ptr, warp by warp, each
//       tile's base the sum of the earlier tiles' counts.
//   (d) a stable LSD radix sort over the ceil(log2(N + 1)) key bits, 8 bits
//       a pass (three passes at N = 141,313): a pass's per-(digit, tile)
//       counts (from the pass's input), their digit-major exclusive scan
//       into scatter offsets (a warp a digit), and a place step that sorts
//       its tile by the digit with BlockRadixSort (stable in the tile's
//       order) and scatters each edge to its digit's offset plus its rank
//       among the tile's edges of that digit.
#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>
#include <cub/block/block_radix_sort.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "load16.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRadixItems = 8;
constexpr int kRadixTile = kThreads * kRadixItems;   // edges a radix tile
constexpr int kScanTile = 4096;                      // counters a scan tile
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kMaxPasses = 4;                        // 31-bit keys
constexpr uint32_t kPadKey = 0xffffffffu;            // past every real key
static_assert(kThreads == kDigits, "one thread per digit");

// the sum's staging: kWarps * kSlots slots of kSlotBytes a block, shared
// out among the warps that read rows; a lane sums 4 columns in each half of
// a 256-column slab of a row
constexpr int kSlabCols = 256;
constexpr int kSlots = 4;
constexpr int kSlotBytes = 2048;

// The scratch buffer, in int32 elements: ptr, one sortedness word per
// radix tile, then the words cleared each call (the key counts, the scan
// tiles' sums, every radix pass's digit totals), then the per-(pass,
// digit, tile) digit counts, order and the two ping-pong buffers of keys
// and edge ids.  segment_matmul.py's _csr_layout computes the same.  The
// grid barrier keeps no word here: it lives in the cooperative launch's
// own workspace.
struct Layout {
  int passes, tiles, scan_tiles;
  int64_t flags, counts, tile_sums, totals, zeroed, hist, order, keys_a,
      vals_a, keys_b, vals_b, total;
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
  L.flags = static_cast<int64_t>(N) + 1;                // ptr at 0
  L.counts = L.flags + L.tiles;
  L.tile_sums = L.counts + N + 1;
  L.totals = L.tile_sums + L.scan_tiles;
  L.zeroed = L.totals + static_cast<int64_t>(L.passes) * kDigits;
  L.hist = L.zeroed;
  L.order = L.hist + static_cast<int64_t>(L.passes) * kDigits * L.tiles;
  L.keys_a = L.order + E;
  L.vals_a = L.keys_a + E;
  L.keys_b = L.vals_a + E;
  L.vals_b = L.keys_b + E;
  L.total = L.vals_b + E;
  return L;
}

// Everything the kernel reads, by value.  Words of `scratch` are written
// and read inside the one launch, so they are read with plain loads (never
// __ldg: the read-only path need not see another block's stores).
struct Params {
  const void* msg;
  const int32_t* dst;
  int32_t* scratch;
  float* out;            // null: build the CSR only
  int E, N, D;
  Layout L;
};

__device__ __forceinline__ int key_of(int d, int N) {
  return static_cast<unsigned>(d) < static_cast<unsigned>(N) ? d : N;
}

__device__ __forceinline__ int digit_of(uint32_t key, int shift) {
  return static_cast<int>((key >> shift) & (kDigits - 1));
}

using Sort = cub::BlockRadixSort<uint32_t, kThreads, kRadixItems, int32_t>;

// scan tiles whose sums the count phase gathers in shared memory first
// (N < 4,194,304); past that, global atomics
constexpr int kSmemScanTiles = 1024;

struct CountSmem {
  int hist[kMaxPasses][kDigits];
  int tile_sums[kSmemScanTiles];
};

struct ScanSmem {
  int before[kWarps];                // each warp's part of the earlier tiles
  int warp_sums[kWarps];             // each warp's counters' sum
};

struct PlaceSmem {
  Sort::TempStorage sort;
  unsigned char digit[kRadixTile];
  int start[kDigits];
};

struct SumSmem {
  alignas(128) unsigned char ring[kWarps * kSlots][kSlotBytes];
  uint64_t full[kWarps * kSlots];
  int reads[kWarps];                 // 1 for a warp with rows to read
};

// one block's shared memory, phase by phase (a grid barrier between two
// phases is also a block barrier)
union CsrSmem {
  CountSmem count;
  ScanSmem scan;
  PlaceSmem place;
};

union Smem {
  CsrSmem csr;
  SumSmem sum;
};

// ------------------------------------------------------------- the CSR
// Edge e of tile `tile`, item i, striped (e = tile start + i * kThreads +
// thread): coalesced reads of dst.
__device__ __forceinline__ int64_t striped(int tile, int i) {
  return static_cast<int64_t>(tile) * kRadixTile + i * kThreads + threadIdx.x;
}

// (a) One tile's sortedness word: 1 if some key is smaller than the one
//     before it (the edge before the tile included).
__device__ void flag_tile(const Params& p, int tile) {
  int descent = 0;
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    const int64_t e = striped(tile, i);
    if (e < p.E && e > 0 &&
        key_of(__ldg(p.dst + e - 1), p.N) > key_of(__ldg(p.dst + e), p.N))
      descent = 1;
  }
  descent = __syncthreads_or(descent);
  if (threadIdx.x == 0) p.scratch[p.L.flags + tile] = descent;
}

// (b, sorted keys) ptr[n] = the first edge with key >= n, and order[e] =
// e.  An edge e whose key exceeds the one before it writes ptr over the
// gap (key[e-1], key[e]]; the whole grid writes the head [0, key[0]] and
// the tail (key[E-1], N].  A lane writes a gap of up to 8 words itself;
// the warp writes a longer one together.
__device__ void fill_sorted(const Params& p) {
  int32_t* ptr = p.scratch;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps
                       + threadIdx.x / 32;
  for (int64_t base = warp * 32; base < p.E; base += warps * 32) {
    const int64_t e = base + lane;
    const bool valid = e < p.E;
    const int k = valid ? key_of(__ldg(p.dst + e), p.N) : 0;
    const int kp = valid && e > 0 ? key_of(__ldg(p.dst + e - 1), p.N) : k;
    if (valid) p.scratch[p.L.order + e] = static_cast<int32_t>(e);
    const bool wide = k - kp > 8;
    if (!wide)
      for (int n = kp + 1; n <= k; ++n) ptr[n] = static_cast<int32_t>(e);
    unsigned todo = __ballot_sync(0xffffffffu, wide);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int lo = __shfl_sync(0xffffffffu, kp, src) + 1;
      const int hi = __shfl_sync(0xffffffffu, k, src);
      const int32_t at = static_cast<int32_t>(
          __shfl_sync(0xffffffffu, static_cast<long long>(e), src));
      for (int n = lo + lane; n <= hi; n += 32) ptr[n] = at;
    }
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kThreads
                     + threadIdx.x;
  const int head = p.E > 0 ? key_of(__ldg(p.dst), p.N) : p.N;
  const int tail = p.E > 0 ? key_of(__ldg(p.dst + p.E - 1), p.N) + 1
                           : p.N + 1;
  for (int64_t n = t0; n <= head; n += stride) ptr[n] = 0;
  for (int64_t n = tail + t0; n <= p.N; n += stride) ptr[n] = p.E;
}

// one atomic add of `lanes` for the warp when all its lanes add to the same
// counter (a run of one key), else one each
__device__ __forceinline__ void count_one(int* counters, int index,
                                          bool valid) {
  const int at = valid ? index : -1;
  const int first = __shfl_sync(0xffffffffu, at, 0);
  if (__all_sync(0xffffffffu, at == first)) {
    if ((threadIdx.x & 31) == 0 && first >= 0) atomicAdd(&counters[first], 32);
  } else if (valid) {
    atomicAdd(&counters[index], 1);
  }
}

// (b, unsorted keys) One tile: each key counted into counts[N + 1] and its
// scan tile's sum, every pass's digit totals into totals[passes][kDigits]
// and the first pass's per-tile digit counts into hist[0][kDigits][tiles].
__device__ void count_tile(const Params& p, int tile, CountSmem& s) {
  const Layout& L = p.L;
  const bool smem_tiles = L.scan_tiles <= kSmemScanTiles;
  for (int i = threadIdx.x; i < kMaxPasses * kDigits; i += kThreads)
    s.hist[i / kDigits][i % kDigits] = 0;
  if (smem_tiles)
    for (int i = threadIdx.x; i < L.scan_tiles; i += kThreads)
      s.tile_sums[i] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    const int64_t e = striped(tile, i);
    const bool valid = e < p.E;
    const int key = valid ? key_of(__ldg(p.dst + e), p.N) : 0;
    count_one(p.scratch + L.counts, key, valid);
    count_one(smem_tiles ? s.tile_sums : p.scratch + L.tile_sums,
              key / kScanTile, valid);
    if (valid)
      for (int q = 0; q < L.passes; ++q)
        atomicAdd(&s.hist[q][digit_of(key, kDigitBits * q)], 1);
  }
  __syncthreads();
  if (smem_tiles)
    for (int i = threadIdx.x; i < L.scan_tiles; i += kThreads)
      if (s.tile_sums[i]) atomicAdd(&p.scratch[L.tile_sums + i],
                                    s.tile_sums[i]);
  const int d = threadIdx.x;
  for (int q = 0; q < L.passes; ++q) {
    const int c = s.hist[q][d];
    if (q == 0)
      p.scratch[L.hist + static_cast<int64_t>(d) * L.tiles + tile] = c;
    if (c) atomicAdd(&p.scratch[L.totals + q * kDigits + d], c);
  }
  __syncthreads();                  // the next tile clears s
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// inclusive prefix sum over the warp's lanes
__device__ __forceinline__ int warp_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// (c) Exclusive scan of scan tile `tile` of counts[0 .. N + 1) into ptr
//     (ptr[N] is the number of kept edges): warp w scans counters [w *
//     512, (w + 1) * 512) of the tile, 32 at a time, coalesced.
__device__ void scan_tile(const Params& p, int tile, ScanSmem& s) {
  constexpr int kPerWarp = kScanTile / kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int32_t* counts = p.scratch + p.L.counts;
  int32_t* ptr = p.scratch;
  const int64_t count = static_cast<int64_t>(p.N) + 1;
  int before = 0;
  for (int b = threadIdx.x; b < tile; b += kThreads)
    before += p.scratch[p.L.tile_sums + b];
  before = warp_sum(before);
  const int64_t first = static_cast<int64_t>(tile) * kScanTile
                        + warp * kPerWarp + lane;
  int v[kPerWarp / 32];
#pragma unroll
  for (int k = 0; k < kPerWarp / 32; ++k)
    v[k] = first + 32 * k < count ? counts[first + 32 * k] : 0;
  int carry = 0;
#pragma unroll
  for (int k = 0; k < kPerWarp / 32; ++k) {
    const int x = warp_scan(v[k]);
    v[k] = carry + x - v[k];
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) {
    s.before[warp] = before;
    s.warp_sums[warp] = carry;
  }
  __syncthreads();
  int base = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    base += s.before[w] + (w < warp ? s.warp_sums[w] : 0);
#pragma unroll
  for (int k = 0; k < kPerWarp / 32; ++k)
    if (first + 32 * k < count) ptr[first + 32 * k] = base + v[k];
  __syncthreads();                  // the next tile reuses s
}

// (c, d) One radix pass's scatter offsets for digit d, by one warp:
//        hist[pass][d][0 .. tiles) becomes the digit-major exclusive prefix
//        (the edges of smaller digits, then of digit d in earlier tiles), in
//        place.
__device__ void digit_scan(const Params& p, int pass, int d) {
  const Layout& L = p.L;
  const int lane = threadIdx.x & 31;
  const int32_t* totals = p.scratch + L.totals + pass * kDigits;
  int carry = 0;
  for (int i = lane; i < d; i += 32) carry += totals[i];
  carry = warp_sum(carry);
  int32_t* row = p.scratch + L.hist
                 + (static_cast<int64_t>(pass) * kDigits + d) * L.tiles;
  for (int base = 0; base < L.tiles; base += 32) {
    const bool in = base + lane < L.tiles;
    const int v = in ? row[base + lane] : 0;
    const int x = warp_scan(v);
    if (in) row[base + lane] = carry + x - v;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
}

// (c, d) The digit scans of one pass, a warp a digit, kWarps digits a unit
__device__ __forceinline__ void digit_scans(const Params& p, int pass,
                                            int unit) {
  digit_scan(p, pass, unit * kWarps + threadIdx.x / 32);
}

// pass p reads buffer (p + 1) % 2 of keys and edge ids and writes p % 2
__device__ __forceinline__ uint32_t* keys_buf(const Params& p, int b) {
  return reinterpret_cast<uint32_t*>(p.scratch
                                     + (b ? p.L.keys_b : p.L.keys_a));
}

__device__ __forceinline__ int32_t* vals_buf(const Params& p, int b) {
  return p.scratch + (b ? p.L.vals_b : p.L.vals_a);
}

// (d) Before a pass p > 0: one tile's digit counts, hist[p][d][tile], from
//     the previous pass's output.
__device__ void digit_count_tile(const Params& p, int pass, int tile,
                                 int (&s_hist)[kDigits]) {
  s_hist[threadIdx.x] = 0;
  __syncthreads();
  const uint32_t* keys = keys_buf(p, (pass + 1) % 2);
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    const int64_t e = striped(tile, i);
    if (e < p.E) atomicAdd(&s_hist[digit_of(keys[e], pass * kDigitBits)], 1);
  }
  __syncthreads();
  p.scratch[p.L.hist + (static_cast<int64_t>(pass) * kDigits + threadIdx.x)
            * p.L.tiles + tile] = s_hist[threadIdx.x];
  __syncthreads();
}

// (d) One radix pass over one tile of kRadixTile edges (blocked: thread t
//     holds positions t * kRadixItems + i).  Pass 0 reads dst and makes
//     the keys; a later pass reads the previous pass's keys and edge ids.
//     The last pass writes order; an earlier one the next pass's input.
__device__ void place_tile(const Params& p, int pass, int tile,
                           PlaceSmem& s) {
  const Layout& L = p.L;
  const int tiles = L.tiles;
  const uint32_t* keys_in = keys_buf(p, (pass + 1) % 2);
  const int32_t* vals_in = vals_buf(p, (pass + 1) % 2);
  uint32_t* keys_out = keys_buf(p, pass % 2);
  int32_t* vals_out = vals_buf(p, pass % 2);
  const int32_t* offsets = p.scratch + L.hist
                           + static_cast<int64_t>(pass) * kDigits * tiles;
  const int64_t tile0 = static_cast<int64_t>(tile) * kRadixTile;

  uint32_t keys[kRadixItems];
  int32_t vals[kRadixItems];
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    const int64_t e = tile0 + threadIdx.x * kRadixItems + i;
    if (e >= p.E) {
      keys[i] = kPadKey;      // sorts after the tile's real edges
      vals[i] = -1;
    } else if (pass == 0) {
      keys[i] = static_cast<uint32_t>(key_of(__ldg(p.dst + e), p.N));
      vals[i] = static_cast<int32_t>(e);
    } else {
      keys[i] = keys_in[e];
      vals[i] = vals_in[e];
    }
  }
  const int shift = pass * kDigitBits;
  Sort(s.sort).Sort(keys, vals, shift, shift + kDigitBits);
  const int pos0 = threadIdx.x * kRadixItems;
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i)
    s.digit[pos0 + i] = static_cast<unsigned char>(digit_of(keys[i], shift));
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    const int pos = pos0 + i;
    if (pos == 0 || s.digit[pos - 1] != s.digit[pos])
      s.start[s.digit[pos]] = pos;
  }
  __syncthreads();
  const bool last = pass == L.passes - 1;
  int32_t* order = p.scratch + L.order;
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    if (vals[i] < 0) continue;
    const int d = digit_of(keys[i], shift);
    const int dest = offsets[static_cast<int64_t>(d) * tiles + tile]
                     + pos0 + i - s.start[d];
    if (last) {
      order[dest] = vals[i];
    } else {
      keys_out[dest] = keys[i];
      vals_out[dest] = vals[i];
    }
  }
  __syncthreads();                  // the next tile reuses the storage
}

// ------------------------------------------------------------- the sum
// The sum's split of the work, in two passes.  The rows: warp g of the
// grid's warps sums the nodes of rows [R * g / warps, R * (g + 1) / warps),
// R = ptr[N] the kept edges: the nodes [the smallest n with ptr[n] >= R *
// g / warps, the same for g + 1), each in one warp, skipping empty ones.
// The zeros: then it zeroes the empty nodes among [N * g / warps, N * (g +
// 1) / warps).

// The smallest n in [0, N] with ptr[n] >= target[k], for both targets at
// once, by the whole warp: 32 probes a round cut each interval 32-fold
// (five dependent rounds at N = 141,313).
__device__ void find_rows(const int32_t* ptr, int N,
                          const int64_t (&target)[2], int (&found)[2]) {
  constexpr int K = 2;
  const int lane = threadIdx.x & 31;
  int lo[K], hi[K];                         // the answer is in [lo, hi]
#pragma unroll
  for (int k = 0; k < K; ++k) lo[k] = 0, hi[k] = N;
  bool open = true;
  while (open) {
    int q[K];
    bool hit[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      q[k] = lo[k] + static_cast<int>(
                         static_cast<int64_t>(hi[k] - lo[k]) * lane / 32);
      hit[k] = lo[k] < hi[k] && ptr[q[k]] >= target[k];
    }
    open = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (lo[k] >= hi[k]) continue;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit[k]);
      const int last_q = __shfl_sync(0xffffffffu, q[k], 31);
      if (!ballot) {
        lo[k] = last_q + 1;
      } else {
        const int f = __ffs(ballot) - 1;
        const int qf = __shfl_sync(0xffffffffu, q[k], f);
        const int qb = __shfl_sync(0xffffffffu, q[k], f > 0 ? f - 1 : 0);
        if (f > 0) lo[k] = qb + 1;
        hi[k] = qf;
      }
      open |= lo[k] < hi[k];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) found[k] = lo[k];
}

// This warp's nodes of the rows pass, [n0, n1), and of the zeros pass,
// [z0, z1).
__device__ __forceinline__ void warp_split(const Params& p, int& n0, int& n1,
                                           int& z0, int& z1) {
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps
                    + threadIdx.x / 32;
  const int64_t rows = p.scratch[p.N];
  const int64_t target[2] = {rows * g / warps, rows * (g + 1) / warps};
  int found[2];
  find_rows(p.scratch, p.N, target, found);
  n0 = found[0];
  n1 = found[1];
  z0 = static_cast<int>(p.N * g / warps);
  z1 = static_cast<int>(p.N * (g + 1) / warps);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// until phase number `parity` (mod 2) of the barrier has completed
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

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from device
// memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared-memory reads of the generic proxy before the bulk copies (the
// async proxy) that follow
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four columns of a staged row as floats: 16 bytes of fp32, 8 of bf16
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&x)[4]);

template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// (e), 16-byte rows.  The rows pass: each warp streams its rows, in CSR
// order, through its slots of the block's ring, and walks its nodes in the
// same order.  Lane l sums columns [4l, 4l + 4) and [128 + 4l, 128 + 4l +
// 4) of each 256-column slab.  The zeros pass: each run of empty nodes'
// output rows is one span of 16-byte stores.  Every value that steers the
// loops is the same in all lanes of the warp.
template <typename T>
__device__ void sum_bulk(const Params& p, bool unsorted, SumSmem& s) {
  constexpr int elem = sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int D = p.D;
  const int32_t* ptr = p.scratch;
  const int32_t* order = p.scratch + p.L.order;
  const unsigned char* msg = static_cast<const unsigned char*>(p.msg);
  const int64_t row_bytes = static_cast<int64_t>(D) * elem;

  // the CSR phases wrote this shared memory through the generic proxy
  fence_proxy_async();
  int n0, n1, z0, z1;
  warp_split(p, n0, n1, z0, z1);
  const int64_t r0 = ptr[n0], r1 = ptr[n1];    // the warp's rows, CSR order
  // the block's slots go to its warps that read rows, in equal parts
  if (lane == 0) s.reads[warp] = r1 > r0;
  __syncthreads();
  int readers = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    readers += s.reads[w];
    before += w < warp ? s.reads[w] : 0;
  }
  auto counts_at = [&](int base, int end) {
    const int n = base + lane;
    return n < end ? ptr[n + 1] - ptr[n] : 0;
  };

  if (r1 > r0) {
    const int slots = kWarps * kSlots / readers;
    const uint32_t ring = smem_u32(&s.ring[before * slots][0]);
    const uint32_t bar0 = smem_u32(&s.full[before * slots]);
    auto bar = [&](int k) { return bar0 + 8 * k; };
    if (lane == 0) {
      for (int k = 0; k < slots; ++k) mbar_init(bar(k), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    const int slabs = (D + kSlabCols - 1) / kSlabCols;
    unsigned parity = 0;                       // bit k: slot k's phase
    int cslot = 0;                             // the slot being read
    for (int slab = 0; slab < slabs; ++slab) {
      const int c0 = slab * kSlabCols;
      const int seg = min(D - c0, kSlabCols);  // columns of this slab
      const int seg_bytes = seg * elem;        // a multiple of 16
      const int rps = min(32, kSlotBytes / seg_bytes);   // rows a slot
      // sorted keys, whole rows: a slot's rows are one contiguous copy
      const bool whole = !unsorted && slabs == 1;
      int64_t next = r0;                       // first row not yet issued
      int islot = cslot;                       // the slot it goes to
      int pre = 0;                             // order[next + lane], ahead
      if (unsorted && lane < rps && next + lane < r1)
        pre = order[next + lane];

      auto issue = [&]() {
        const int rows = static_cast<int>(r1 - next < rps ? r1 - next : rps);
        const uint32_t dst = ring + islot * kSlotBytes;
        __syncwarp();                // every lane is done reading the slot
        if (lane == 0) {
          fence_proxy_async();
          mbar_expect_tx(bar(islot), static_cast<uint32_t>(rows * seg_bytes));
          if (whole)
            bulk_copy(dst, msg + next * row_bytes,
                      static_cast<uint32_t>(rows * seg_bytes), bar(islot));
        }
        if (!whole) {
          __syncwarp();              // the bytes are expected first
          if (lane < rows) {
            fence_proxy_async();
            const int64_t src = unsorted ? pre : next + lane;
            bulk_copy(dst + lane * seg_bytes,
                      msg + src * row_bytes + static_cast<int64_t>(c0) * elem,
                      static_cast<uint32_t>(seg_bytes), bar(islot));
          }
        }
        next += rows;
        islot = islot + 1 == slots ? 0 : islot + 1;
        if (unsorted && lane < rps && next + lane < r1)
          pre = order[next + lane];
      };
      for (int k = 0; k < slots && next < r1; ++k) issue();

      int64_t row = r0;                        // the next row to read
      int srow = 0, slot_rows = 0;             // its place in its slot
      int cnt = counts_at(n0, n1);
      for (int base = n0; base < n1; base += 32) {
        const int cnt_next = base + 32 < n1 ? counts_at(base + 32, n1) : 0;
        const int count = min(32, n1 - base);
        for (int i = 0; i < count; ++i) {
          const int edges = __shfl_sync(0xffffffffu, cnt, i);
          if (edges == 0) continue;            // the zeros pass's
          float acc[8];
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[v] = 0.f;
          for (int e = 0; e < edges; ++e) {
            if (srow == 0) {
              slot_rows = static_cast<int>(r1 - row < rps ? r1 - row : rps);
              mbar_wait(bar(cslot), (parity >> cslot) & 1);
            }
            const T* staged = reinterpret_cast<const T*>(
                &s.ring[before * slots + cslot][0] + srow * seg_bytes);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = h * 128 + lane * 4;
              if (c < seg) {
                float x[4];
                load4<T>(staged + c, x);
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[h * 4 + v] += x[v];
              }
            }
            ++row;
            if (++srow == slot_rows) {         // the slot is read: refill it
              parity ^= 1u << cslot;
              cslot = cslot + 1 == slots ? 0 : cslot + 1;
              srow = 0;
              if (next < r1) issue();
            }
          }
          float* o = p.out + static_cast<int64_t>(base + i) * D + c0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = h * 128 + lane * 4;
            if (c < seg)
              *reinterpret_cast<float4*>(o + c) =
                  make_float4(acc[h * 4], acc[h * 4 + 1], acc[h * 4 + 2],
                              acc[h * 4 + 3]);
          }
        }
        cnt = cnt_next;
      }
    }
  }

  // the zeros pass: runs of empty nodes [from, to), their output rows one
  // span, in 16-byte stores of all lanes
  auto zero_rows = [&](int from, int to) {
    float4* o = reinterpret_cast<float4*>(p.out + static_cast<int64_t>(from)
                                                      * D);
    const int64_t n4 = static_cast<int64_t>(to - from) * (D / 4);
    for (int64_t i = lane; i < n4; i += 32)
      o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  };
  int empty = z0;                              // empty nodes [empty, node)
  int cnt = counts_at(z0, z1);
  for (int base = z0; base < z1; base += 32) {
    const int cnt_next = base + 32 < z1 ? counts_at(base + 32, z1) : 0;
    unsigned full = __ballot_sync(0xffffffffu, cnt != 0 && base + lane < z1);
    while (full) {                             // each node with edges
      const int at = base + __ffs(full) - 1;
      full &= full - 1;
      zero_rows(empty, at);
      empty = at + 1;
    }
    cnt = cnt_next;
  }
  zero_rows(empty, z1);
}

template <typename T>
__device__ __forceinline__ float to_float(T x);

template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (e), any D and alignment: each warp's nodes of the rows pass as above,
// lanes over the columns, one element a load straight from device memory;
// then the zeros pass, one element a store
template <typename T>
__device__ void sum_plain(const Params& p, bool unsorted) {
  const int lane = threadIdx.x & 31;
  const int32_t* ptr = p.scratch;
  const int32_t* order = p.scratch + p.L.order;
  const T* msg = static_cast<const T*>(p.msg);
  int n0, n1, z0, z1;
  warp_split(p, n0, n1, z0, z1);
  for (int n = n0; n < n1; ++n) {
    const int e0 = ptr[n], e1 = ptr[n + 1];
    if (e0 == e1) continue;
    float* o = p.out + static_cast<int64_t>(n) * p.D;
    for (int c = lane; c < p.D; c += 32) {
      float acc = 0.f;
      for (int i = e0; i < e1; ++i) {
        const int64_t r = unsorted ? order[i] : i;
        acc += to_float<T>(msg[r * p.D + c]);
      }
      o[c] = acc;
    }
  }
  for (int n = z0; n < z1; ++n)
    if (ptr[n] == ptr[n + 1]) {
      float* o = p.out + static_cast<int64_t>(n) * p.D;
      for (int c = lane; c < p.D; c += 32) o[c] = 0.f;
    }
}

// The whole call: the CSR phases, then (out not null) the sum.
template <typename T, bool kBulk>
__global__ void __launch_bounds__(kThreads, 2)
segment_matmul_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const Layout& L = p.L;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kThreads
                     + threadIdx.x;

  // (a) each tile's sortedness word; clear the counters
  for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x)
    flag_tile(p, tile);
  for (int64_t i = L.counts + t0; i < L.zeroed; i += stride) p.scratch[i] = 0;
  grid.sync();
  int descent = 0;
  for (int t = threadIdx.x; t < L.tiles; t += kThreads)
    descent |= p.scratch[L.flags + t];
  const bool unsorted = __syncthreads_or(descent);
  if (!unsorted) {
    // (b) ptr and order straight from the sorted keys
    fill_sorted(p);
    grid.sync();
  } else {
    // (b) count
    for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x)
      count_tile(p, tile, s.csr.count);
    grid.sync();
    // (c) scan into ptr; the first radix pass's digit scans
    for (int u = blockIdx.x; u < L.scan_tiles + kDigits / kWarps;
         u += gridDim.x) {
      if (u < L.scan_tiles) scan_tile(p, u, s.csr.scan);
      else digit_scans(p, 0, u - L.scan_tiles);
    }
    grid.sync();
    // (d) the radix passes
    for (int pass = 0; pass < L.passes; ++pass) {
      if (pass > 0) {
        for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x)
          digit_count_tile(p, pass, tile, s.csr.count.hist[0]);
        grid.sync();
        for (int u = blockIdx.x; u < kDigits / kWarps; u += gridDim.x)
          digit_scans(p, pass, u);
        grid.sync();
      }
      for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x)
        place_tile(p, pass, tile, s.csr.place);
      grid.sync();
    }
  }
  if (p.out == nullptr) return;
  // (e) the sum
  if constexpr (kBulk) sum_bulk<T>(p, unsorted, s.sum);
  else sum_plain<T>(p, unsorted);
}

// Bytes of dynamic shared memory an instance takes: the CSR phases' union,
// and with bulk copies the sum's ring and barriers.
template <bool kBulk>
constexpr size_t smem_bytes() {
  return kBulk ? sizeof(Smem) : sizeof(CsrSmem);
}

constexpr int kMaxDevices = 64;

// The cooperative launch of one instance: as many blocks as fit on the
// card at once (its occupancy times its SMs), queried at the first call on
// each device and kept.
template <typename T, bool kBulk>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  static int grid_blocks[kMaxDevices];
  const auto kernel = segment_matmul_kernel<T, kBulk>;
  constexpr size_t smem = smem_bytes<kBulk>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int blocks = grid_blocks[dev];
  if (blocks == 0) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    blocks = grid_blocks[dev] = per_sm * sms;
  }
  Params arg = prm;
  void* args[] = {&arg};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(blocks), dim3(kThreads), args, smem,
                                     stream);
}

}  // namespace

// The CSR of dst into `scratch` (int32, at least scratch_elems elements as
// _csr_layout sizes it), then, unless out is null, the sum of msg into out:
// one cooperative launch either way.  dtype: 0 = fp32, 1 = bf16 messages.
// Launches on `stream`, reads nothing back, and returns the launch's CUDA
// error (0 = launched).
extern "C" int segment_matmul_launch(const void* msg, const void* dst,
                                     void* scratch, long long scratch_elems,
                                     void* out, int E, int num_nodes, int D,
                                     int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L = layout(E, num_nodes);
  if (E < 0 || num_nodes < 1 || scratch_elems < L.total ||
      (out != nullptr && D < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{msg, static_cast<const int32_t*>(dst),
                   static_cast<int32_t*>(scratch), static_cast<float*>(out),
                   E, num_nodes, D, L};
  cudaError_t err;
  if (out == nullptr) {
    err = launch<float, false>(prm, s);
  } else if (dtype == 0) {
    err = vec16_ok(msg, D, 4) ? launch<float, true>(prm, s)
                              : launch<float, false>(prm, s);
  } else {
    err = vec16_ok(msg, D, 2) ? launch<__nv_bfloat16, true>(prm, s)
                              : launch<__nv_bfloat16, false>(prm, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* segment_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
