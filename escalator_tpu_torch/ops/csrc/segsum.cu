// Exact int64 per-segment sums, in one launch per call.
//
// Replaces the Pallas TPU kernel escalator_tpu/ops/pallas_kernel.py:113
// (_agg_kernel, launched by _pallas_partials :146, wrapped by
// fused_segment_sums :177). Two entry points share one tile body:
// - segsum_launch: the generic sum of that wrapper, pre-masked columns under
//   any ids, up to 8 int64 and 8 count columns (a narrow build serves up to
//   2 and 4, which covers every sweep of the decide);
// - segsum_decide_launch: the decide's three sweeps in one grid, from the raw
//   pod and node arrays. Pod lanes give the per-group request sums and pod
//   count and the per-node pod count; node lanes give the per-group capacity
//   over untainted nodes and the node, untainted, tainted and cordoned
//   counts. The masks are derived in registers.
//
// What bounds it on an H100: bytes. A decide must read every lane's valid
// flag, a valid pod's group, node, cpu and mem, a valid node's group, flags,
// cpu and mem, and write [9, G] + [N] int64 sums: about 4.4 MB at the
// north-star shape (100k pods in 131072 lanes, 50k nodes in 65536 lanes,
// 2048 groups), about 1.3 us at 3.35 TB/s. The adds are a few per byte. At
// that size one launch's fixed cost is as large as the bound, and a chain of
// dependent loads or a second launch adds as much again, so the design cuts
// launches and dependent loads:
// - One grid covers both arrays: blocks below pod_blocks take pod lanes, the
//   rest node lanes. A pod lane carries about 25 bytes and a node lane 23,
//   so equal tiles of lanes give every block about the same bytes to read.
// - A thread takes kLanes consecutive lanes and issues every load of its
//   tile before it uses one: the valid flags as one 4-byte word, ids as one
//   int4, each int64 column as two longlong2. A padding lane's bytes are read
//   and never counted. An unaligned pointer or the ragged tail takes one
//   scalar load per lane. The only dependent load is a pod's gather of its
//   node's group (the same-group filter of the per-node count).
// - A pod lane is read once for both of its sums, keyed by group and by node.
// - The packer lays lanes out group-contiguously, so neighbours mostly share
//   a key. A thread adds its lanes' runs of equal keys; a run that ends
//   inside the thread goes straight to an atomicAdd, its last run joins the
//   warp's merge (ballot of run tails, segmented shuffle scan), and the
//   run's first thread issues one 64-bit atomicAdd per nonzero column.
//   Counts travel packed, four 16-bit fields to a word (a warp run holds at
//   most 32 * kLanes lanes).
// - Integer addition mod 2^64 is associative and commutative, so the result
//   is bit-equal to an int64 index_add_ of each column on every input, in
//   any order of atomics: interleaved ids, values >= 2^48, negative values
//   and any lane count. The TPU kernel's limbs, int32 accumulator, windows
//   and scatter fallbacks have no counterpart; there is no fallback.
// - The caller hands in a zeroed output. A valid lane whose id lies outside
//   [0, segments) adds nothing to it and one to *bad, which the caller reads
//   back once; an invalid lane's id is never used.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kLanes = 4;                       // consecutive lanes per thread
constexpr int kThreads = 128;                   // threads per block
constexpr long long kTile = kLanes * kThreads;  // lanes per block
static_assert(kLanes % 4 == 0, "vector loads take lanes four at a time");
constexpr int kMaxIntColumns = 8;
constexpr int kMaxCountColumns = 8;
constexpr int kCountsPerWord = 4;               // 16-bit fields in a packed word
// the generic entry's narrow build, which holds every sweep of the decide
constexpr int kNarrowIntColumns = 2;
constexpr int kNarrowCountColumns = 4;
constexpr int kDecideGroupColumns = 9;          // rows of the decide's [9, G] sums
constexpr unsigned kFullMask = 0xffffffffu;

// ---------------------------------------------------------------- loads

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// kLanes consecutive elements from lane i0 of an n-lane array (0 past its
// end): 16-byte vector loads (4-byte for flags) when every lane is in range
// and the pointer is aligned, else one load per lane
__device__ __forceinline__ void load_lanes(const int* p, long long i0, long long n,
                                           int (&v)[kLanes]) {
  if (i0 + kLanes <= n && aligned(p + i0, 16)) {
#pragma unroll
    for (int l = 0; l < kLanes; l += 4) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(p + i0 + l));
      v[l] = x.x; v[l + 1] = x.y; v[l + 2] = x.z; v[l + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int l = 0; l < kLanes; ++l) v[l] = i0 + l < n ? __ldg(p + i0 + l) : 0;
  }
}

__device__ __forceinline__ void load_lanes(const long long* p, long long i0, long long n,
                                           long long (&v)[kLanes]) {
  if (i0 + kLanes <= n && aligned(p + i0, 16)) {
#pragma unroll
    for (int l = 0; l < kLanes; l += 2) {
      const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(p + i0 + l));
      v[l] = x.x; v[l + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int l = 0; l < kLanes; ++l) v[l] = i0 + l < n ? __ldg(p + i0 + l) : 0;
  }
}

__device__ __forceinline__ void load_lanes(const unsigned char* p, long long i0, long long n,
                                           bool (&v)[kLanes]) {
  if (i0 + kLanes <= n && aligned(p + i0, 4)) {
#pragma unroll
    for (int l = 0; l < kLanes; l += 4) {
      const uchar4 x = __ldg(reinterpret_cast<const uchar4*>(p + i0 + l));
      v[l] = x.x != 0; v[l + 1] = x.y != 0; v[l + 2] = x.z != 0; v[l + 3] = x.w != 0;
    }
  } else {
#pragma unroll
    for (int l = 0; l < kLanes; ++l) v[l] = i0 + l < n && __ldg(p + i0 + l) != 0;
  }
}

// ---------------------------------------------------------------- runs

__device__ __forceinline__ u64 count_field(u64 word, int field) {
  return (word >> (16 * field)) & 0xffffull;
}

__device__ __forceinline__ void add_nonzero(u64* at, u64 v) {
  if (v != 0) atomicAdd(at, v);
}

// Sum of v over lanes [lane, end] of this warp (end >= lane, same for every
// lane of a run): a Hillis-Steele suffix scan that stops at the run's end.
__device__ __forceinline__ u64 run_sum(u64 v, int lane, int end) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u64 other = __shfl_down_sync(kFullMask, v, off);
    if (lane + off <= end) v += other;
  }
  return v;
}

// Adds the W words of each of this thread's kLanes lanes into sink under the
// lane's key (key < 0: the lane adds nothing). Every thread of the warp must
// call it. sink.uses(w) is warp-uniform: an unused word is never shuffled.
template <int W, class Sink>
__device__ __forceinline__ void sum_runs(const int (&key)[kLanes], const u64 (&val)[kLanes][W],
                                         const Sink& sink) {
  int cur = -1;
  u64 acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = 0;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    if (key[l] < 0) continue;
    if (key[l] != cur) {
      if (cur >= 0) sink.add(cur, acc);  // a run that ends inside the thread
      cur = key[l];
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = val[l][w];
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] += val[l][w];
    }
  }
  // the thread's last run joins the warp's runs of equal keys
  const int lane = threadIdx.x & 31;
  const int next = __shfl_down_sync(kFullMask, cur, 1);
  const int prev = __shfl_up_sync(kFullMask, cur, 1);
  const unsigned tails = __ballot_sync(kFullMask, lane == 31 || next != cur);
  const int end = __ffs(tails & (kFullMask << lane)) - 1;
  const bool head = lane == 0 || prev != cur;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (sink.uses(w)) acc[w] = run_sum(acc[w], lane, end);
  }
  if (head && cur >= 0) sink.add(cur, acc);
}

// ---------------------------------------------------------------- sinks

// The generic [segments, n_ints + n_counts] row-major output, for at most
// kInts int64 and kCounts count columns: words [0, kInts) are the int64
// columns, the rest the packed counts.
template <int kInts, int kCounts>
struct GenericSink {
  static constexpr int kWords = kInts + (kCounts + kCountsPerWord - 1) / kCountsPerWord;
  u64* out;
  int n_ints;
  int n_counts;

  __device__ bool uses(int w) const {
    return w < kInts ? w < n_ints : (w - kInts) * kCountsPerWord < n_counts;
  }
  __device__ void add(int key, const u64 (&acc)[kWords]) const {
    u64* row = out + static_cast<long long>(key) * (n_ints + n_counts);
#pragma unroll
    for (int c = 0; c < kInts; ++c) {
      if (c < n_ints) add_nonzero(row + c, acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kCounts; ++c) {
      if (c < n_counts) {
        add_nonzero(row + n_ints + c,
                    count_field(acc[kInts + c / kCountsPerWord], c % kCountsPerWord));
      }
    }
  }
};

// W consecutive rows, from row `first`, of the decide's [9, G] sums
template <int W>
struct GroupRowsSink {
  u64* out;
  long long groups;
  int first;

  __device__ bool uses(int) const { return true; }
  __device__ void add(int key, const u64 (&acc)[W]) const {
#pragma unroll
    for (int w = 0; w < W; ++w) add_nonzero(out + (first + w) * groups + key, acc[w]);
  }
};

// the node lanes' sums: capacity rows 3, 4 and the four counts packed in
// word 2 into rows 5-8
struct NodeRowsSink {
  u64* out;
  long long groups;

  __device__ bool uses(int) const { return true; }
  __device__ void add(int key, const u64 (&acc)[3]) const {
    add_nonzero(out + 3 * groups + key, acc[0]);
    add_nonzero(out + 4 * groups + key, acc[1]);
#pragma unroll
    for (int f = 0; f < kCountsPerWord; ++f) {
      add_nonzero(out + (5 + f) * groups + key, count_field(acc[2], f));
    }
  }
};

// the per-node pod counts, [N] after the [9, G] rows
struct NodeCountSink {
  u64* out;

  __device__ bool uses(int) const { return true; }
  __device__ void add(int key, const u64 (&acc)[1]) const { add_nonzero(out + key, acc[0]); }
};

// ---------------------------------------------------------------- kernels

struct Columns {
  const long long* ints[kMaxIntColumns];
  const unsigned char* counts[kMaxCountColumns];
  int n_ints;
  int n_counts;
};

__device__ __forceinline__ long long first_lane(long long tile) {
  return tile * kTile + static_cast<long long>(threadIdx.x) * kLanes;
}

__device__ __forceinline__ bool in_range(int id, long long segments) {
  return id >= 0 && id < segments;
}

// The generic sum for at most kInts int64 and kCounts count columns: the
// launch takes the narrow build when the columns fit, since every column of
// capacity costs registers and instructions in every thread.
template <int kInts, int kCounts>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const int* __restrict__ ids, const unsigned char* __restrict__ valid,
              long long lanes, long long segments, Columns cols, u64* __restrict__ out,
              u64* __restrict__ bad) {
  using Sink = GenericSink<kInts, kCounts>;
  const long long i0 = first_lane(blockIdx.x);
  bool live[kLanes];
  int id[kLanes];
  long long ints[kInts][kLanes];
  bool counts[kCounts][kLanes];
  load_lanes(valid, i0, lanes, live);
  load_lanes(ids, i0, lanes, id);
#pragma unroll
  for (int c = 0; c < kInts; ++c) {
    if (c < cols.n_ints) load_lanes(cols.ints[c], i0, lanes, ints[c]);
  }
#pragma unroll
  for (int c = 0; c < kCounts; ++c) {
    if (c < cols.n_counts) load_lanes(cols.counts[c], i0, lanes, counts[c]);
  }

  int key[kLanes];
  u64 val[kLanes][Sink::kWords];
  unsigned n_bad = 0;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    n_bad += live[l] && !in_range(id[l], segments);
    key[l] = live[l] && in_range(id[l], segments) ? id[l] : -1;
#pragma unroll
    for (int w = 0; w < Sink::kWords; ++w) val[l][w] = 0;
#pragma unroll
    for (int c = 0; c < kInts; ++c) {
      if (c < cols.n_ints) val[l][c] = static_cast<u64>(ints[c][l]);
    }
#pragma unroll
    for (int c = 0; c < kCounts; ++c) {
      if (c < cols.n_counts && counts[c][l]) {
        val[l][kInts + c / kCountsPerWord] |= 1ull << (16 * (c % kCountsPerWord));
      }
    }
  }
  if (n_bad) atomicAdd(bad, static_cast<u64>(n_bad));
  sum_runs(key, val, Sink{out, cols.n_ints, cols.n_counts});
}

struct PodLanes {
  const unsigned char* valid;
  const int* group;
  const int* node;
  const long long* cpu;
  const long long* mem;
  long long lanes;
};

struct NodeLanes {
  const unsigned char* valid;
  const int* group;
  const unsigned char* tainted;
  const unsigned char* cordoned;
  const long long* cpu;
  const long long* mem;
  long long lanes;
};

// Pod lanes: rows 0-2 (cpu_req, mem_req, num_pods) keyed by group, and the
// per-node count keyed by node. A pod counts for its node when it is valid,
// on a node (node >= 0), and of the group that the raw node-group column
// gives its node lane (clamped to the last lane), as node_pods_sweep_inputs.
__device__ __forceinline__ void pod_tile(const PodLanes& p, const NodeLanes& n, long long tile,
                                         long long groups, u64* out, u64* bad) {
  const long long i0 = first_lane(tile);
  bool live[kLanes];
  int group[kLanes], node[kLanes];
  long long cpu[kLanes], mem[kLanes];
  load_lanes(p.valid, i0, p.lanes, live);
  load_lanes(p.group, i0, p.lanes, group);
  load_lanes(p.node, i0, p.lanes, node);
  load_lanes(p.cpu, i0, p.lanes, cpu);
  load_lanes(p.mem, i0, p.lanes, mem);
  int node_group[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const long long at = node[l] < n.lanes ? node[l] : n.lanes - 1;
    node_group[l] = live[l] && node[l] >= 0 ? __ldg(n.group + at) : 0;
  }

  int group_key[kLanes], node_key[kLanes];
  u64 group_val[kLanes][3], node_val[kLanes][1];
  unsigned n_bad = 0;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    n_bad += live[l] && !in_range(group[l], groups);
    group_key[l] = live[l] && in_range(group[l], groups) ? group[l] : -1;
    group_val[l][0] = static_cast<u64>(cpu[l]);
    group_val[l][1] = static_cast<u64>(mem[l]);
    group_val[l][2] = 1;
    const bool counted = live[l] && node[l] >= 0 && group[l] == node_group[l];
    n_bad += counted && node[l] >= n.lanes;
    node_key[l] = counted && node[l] < n.lanes ? node[l] : -1;
    node_val[l][0] = 1;
  }
  if (n_bad) atomicAdd(bad, static_cast<u64>(n_bad));
  sum_runs(group_key, group_val, GroupRowsSink<3>{out, groups, 0});
  sum_runs(node_key, node_val, NodeCountSink{out + kDecideGroupColumns * groups});
}

// Node lanes: rows 3-8 keyed by group, with the masks of
// node_selection_masks (order_tail.py): untainted = valid & !tainted &
// !cordoned, tainted = valid & tainted & !cordoned, cordoned = valid &
// cordoned; capacity counts untainted nodes only.
__device__ __forceinline__ void node_tile(const NodeLanes& n, long long tile, long long groups,
                                          u64* out, u64* bad) {
  const long long i0 = first_lane(tile);
  bool live[kLanes], tainted[kLanes], cordoned[kLanes];
  int group[kLanes];
  long long cpu[kLanes], mem[kLanes];
  load_lanes(n.valid, i0, n.lanes, live);
  load_lanes(n.group, i0, n.lanes, group);
  load_lanes(n.tainted, i0, n.lanes, tainted);
  load_lanes(n.cordoned, i0, n.lanes, cordoned);
  load_lanes(n.cpu, i0, n.lanes, cpu);
  load_lanes(n.mem, i0, n.lanes, mem);

  int key[kLanes];
  u64 val[kLanes][3];
  unsigned n_bad = 0;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    n_bad += live[l] && !in_range(group[l], groups);
    key[l] = live[l] && in_range(group[l], groups) ? group[l] : -1;
    const bool untainted = !tainted[l] && !cordoned[l];
    val[l][0] = untainted ? static_cast<u64>(cpu[l]) : 0;
    val[l][1] = untainted ? static_cast<u64>(mem[l]) : 0;
    val[l][2] = 1ull | static_cast<u64>(untainted) << 16 |
                static_cast<u64>(tainted[l] && !cordoned[l]) << 32 |
                static_cast<u64>(cordoned[l]) << 48;
  }
  if (n_bad) atomicAdd(bad, static_cast<u64>(n_bad));
  sum_runs(key, val, NodeRowsSink{out, groups});
}

__global__ void __launch_bounds__(kThreads)
segsum_decide_kernel(PodLanes p, NodeLanes n, long long groups, long long pod_blocks,
                     u64* __restrict__ out, u64* __restrict__ bad) {
  if (static_cast<long long>(blockIdx.x) < pod_blocks) {
    pod_tile(p, n, blockIdx.x, groups, out, bad);
  } else {
    node_tile(n, blockIdx.x - pod_blocks, groups, out, bad);
  }
}

long long tiles(long long lanes) { return (lanes + kTile - 1) / kTile; }

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on the given
// stream and returns cudaGetLastError() after the launch.

// Adds the per-segment sums of the valid lanes into out ([segments, n_ints +
// n_counts] int64, zeroed by the caller), and the number of valid lanes with
// an id outside [0, segments) into *bad (one int64).
extern "C" int segsum_launch(const void* ids, const void* valid, long long lanes,
                             const void* const* int_columns, int n_ints,
                             const void* const* count_columns, int n_counts,
                             void* out, long long segments, void* bad, int device,
                             void* stream) {
  if (lanes < 0 || segments < 0 || n_ints < 0 || n_ints > kMaxIntColumns || n_counts < 0 ||
      n_counts > kMaxCountColumns || tiles(lanes) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lanes == 0) return static_cast<int>(cudaSuccess);

  Columns cols{};
  cols.n_ints = n_ints;
  cols.n_counts = n_counts;
  for (int c = 0; c < n_ints; ++c) {
    cols.ints[c] = static_cast<const long long*>(int_columns[c]);
  }
  for (int c = 0; c < n_counts; ++c) {
    cols.counts[c] = static_cast<const unsigned char*>(count_columns[c]);
  }
  const bool narrow = n_ints <= kNarrowIntColumns && n_counts <= kNarrowCountColumns;
  const auto kernel = narrow ? segsum_kernel<kNarrowIntColumns, kNarrowCountColumns>
                             : segsum_kernel<kMaxIntColumns, kMaxCountColumns>;
  kernel<<<static_cast<unsigned>(tiles(lanes)), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const unsigned char*>(valid), lanes, segments,
      cols, static_cast<u64*>(out), static_cast<u64*>(bad));
  return static_cast<int>(cudaGetLastError());
}

// The decide's three sweeps in one launch. out is one zeroed int64 buffer:
// [9, groups] rows (cpu_req, mem_req, num_pods, cpu_cap, mem_cap, num_nodes,
// num_untainted, num_tainted, num_cordoned), then [nodes] per-node pod
// counts. Bool arrays are one byte a lane; groups and nodes index int32 ids.
extern "C" int segsum_decide_launch(
    const void* pod_valid, const void* pod_group, const void* pod_node, const void* pod_cpu,
    const void* pod_mem, long long pods, const void* node_valid, const void* node_group,
    const void* node_tainted, const void* node_cordoned, const void* node_cpu,
    const void* node_mem, long long nodes, long long groups, void* out, void* bad, int device,
    void* stream) {
  if (pods < 0 || nodes < 0 || groups < 0 || (pods > 0 && nodes == 0) ||
      tiles(pods) + tiles(nodes) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = tiles(pods) + tiles(nodes);
  if (blocks == 0) return static_cast<int>(cudaSuccess);

  const PodLanes p{static_cast<const unsigned char*>(pod_valid),
                   static_cast<const int*>(pod_group), static_cast<const int*>(pod_node),
                   static_cast<const long long*>(pod_cpu),
                   static_cast<const long long*>(pod_mem), pods};
  const NodeLanes n{static_cast<const unsigned char*>(node_valid),
                    static_cast<const int*>(node_group),
                    static_cast<const unsigned char*>(node_tainted),
                    static_cast<const unsigned char*>(node_cordoned),
                    static_cast<const long long*>(node_cpu),
                    static_cast<const long long*>(node_mem), nodes};
  segsum_decide_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      p, n, groups, tiles(pods), static_cast<u64*>(out), static_cast<u64*>(bad));
  return static_cast<int>(cudaGetLastError());
}
