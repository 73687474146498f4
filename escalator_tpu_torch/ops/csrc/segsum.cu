// Exact int64 per-segment sums of up to 16 columns in one sweep.
//
// Replaces the Pallas TPU kernel escalator_tpu/ops/pallas_kernel.py:113
// (_agg_kernel, launched by _pallas_partials :146, wrapped by
// fused_segment_sums :177). The decide runs it once over the [P] pod lanes
// (2 int64 columns + 1 count) and once over the [N] node lanes (2 int64
// columns + 4 counts), plus once over the pods into their [N] nodes for the
// per-node pod count.
//
// What bounds it on an H100: bytes. Every lane's 1-byte valid flag is read;
// a valid lane's 4-byte id and its columns (8 bytes per int64 column, 1 byte
// per count column) are read once, a padding lane's never; every output cell
// is written once. The adds are a few per byte. At the north-star shape
// (100k pods in 131072 lanes, 50k nodes in 65536 lanes, 2048 groups) the
// three launches of one decide must move about 4.5 MB, about 1.4 us at
// 3.35 TB/s, so launching costs more than the sweeps themselves.
//
// Design. The TPU kernel turned the scatter into one-hot MXU matmuls over
// 512-lane tiles, split each int64 into six 8-bit limbs so bf16 passes stay
// exact, accumulated in int32 and fell back to an XLA scatter for values
// >= 2^48, more than 2^23 lanes or tiles spanning too many groups. None of
// that is needed here: Hopper adds 64-bit integers atomically.
// - Each thread owns one lane per grid-stride step; the 32 lanes of a warp
//   are neighbours, and invalid lanes contribute nothing.
// - The packer lays lanes out group-contiguously, so neighbours mostly share
//   an id. A warp finds its runs of equal ids (ballot of run tails) and sums
//   each run with a segmented shuffle scan; only the run's first lane issues
//   one atomicAdd per column. Interleaved ids just make shorter runs.
// - Integer addition mod 2^64 is associative and commutative, so the result
//   is bit-equal to an int64 index_add_ of each column on every input, in any
//   order of atomics: interleaved ids, values >= 2^48, negative values
//   (two's-complement wrap) and any lane count. No fallback exists.
// - The wrapper (ops/segsum.py) checks dtypes and shapes and hands in a
//   zeroed [segments, columns] int64 output. A valid lane whose id lies
//   outside [0, segments) adds nothing to the output and one to *bad, which
//   the caller reads back once (a decide reads it once for its three
//   launches) and raises on; no pass over the ids runs before the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxIntColumns = 8;
constexpr int kMaxCountColumns = 8;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;
constexpr unsigned kFullMask = 0xffffffffu;

struct Columns {
  const long long* ints[kMaxIntColumns];
  const unsigned char* counts[kMaxCountColumns];
  int n_ints;
  int n_counts;
};

// Sum of v over lanes [lane, end] of this warp (end >= lane, same for every
// lane of a run): a Hillis-Steele suffix scan that stops at the run's end.
__device__ __forceinline__ unsigned long long run_sum(unsigned long long v,
                                                      int lane, int end) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long other = __shfl_down_sync(kFullMask, v, off);
    if (lane + off <= end) v += other;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const int* __restrict__ ids, const unsigned char* __restrict__ valid,
              long long lanes, long long segments, Columns cols,
              unsigned long long* __restrict__ out,
              unsigned long long* __restrict__ bad) {
  const int lane = threadIdx.x & 31;
  const int n_cols = cols.n_ints + cols.n_counts;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // base is the same for the 32 threads of a warp, so the loop condition is
  // warp-uniform and every shuffle sees the full mask
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31);
       base < lanes; base += stride) {
    const long long i = base + lane;
    bool live = i < lanes && valid[i];
    const int id = live ? ids[i] : -1;
    const bool in_range = id >= 0 && id < segments;
    if (live && !in_range) atomicAdd(bad, 1ull);
    live = live && in_range;
    const int key = live ? id : -1;

    const int next_key = __shfl_down_sync(kFullMask, key, 1);
    const int prev_key = __shfl_up_sync(kFullMask, key, 1);
    const unsigned tails = __ballot_sync(kFullMask, lane == 31 || next_key != key);
    const int end = __ffs(tails & (kFullMask << lane)) - 1;
    const bool head = lane == 0 || prev_key != key;
    unsigned long long* row = out + static_cast<long long>(live ? key : 0) * n_cols;

#pragma unroll
    for (int c = 0; c < kMaxIntColumns; ++c) {
      if (c < cols.n_ints) {
        const unsigned long long v =
            live ? static_cast<unsigned long long>(cols.ints[c][i]) : 0ull;
        const unsigned long long s = run_sum(v, lane, end);
        if (head && live) atomicAdd(row + c, s);
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxCountColumns; ++c) {
      if (c < cols.n_counts) {
        const unsigned long long v = live ? cols.counts[c][i] : 0ull;
        const unsigned long long s = run_sum(v, lane, end);
        if (head && live) atomicAdd(row + cols.n_ints + c, s);
      }
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Adds the per-segment sums of the
// valid lanes into out ([segments, n_ints + n_counts] int64, zeroed by the
// caller), and the number of valid lanes with an id outside [0, segments)
// into *bad (one int64), on the given stream. Returns cudaGetLastError()
// after the launch.
extern "C" int segsum_launch(const void* ids, const void* valid, long long lanes,
                             const void* const* int_columns, int n_ints,
                             const void* const* count_columns, int n_counts,
                             void* out, long long segments, void* bad, int device,
                             void* stream) {
  if (lanes < 0 || segments < 0 || n_ints < 0 || n_ints > kMaxIntColumns ||
      n_counts < 0 || n_counts > kMaxCountColumns) {
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
  long long blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  segsum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const unsigned char*>(valid),
      lanes, segments, cols, static_cast<unsigned long long*>(out),
      static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}
