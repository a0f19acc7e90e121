// Deterministic segment sums, for Hopper (sm_90a).
//
// Port-only kernel: no Pallas kernel stands behind it.  It replaces the float
// scatter-adds (`.at[idx].add`) of fastslam_tpu/backend/pose_graph.py:
// landmark_system_sparse, _assemble_sym3 and backsubstitute_landmarks_sparse
// (:315-419), and the dense landmark_system's (:208-236), which XLA lowers to
// scatters.  A float scatter-add on the card (index_add_, scatter_add_,
// index_put_ with accumulate) adds in the order its atomics land, which
// changes from run to run; the backend's runs must repeat bit for bit.
//
// The function: C value columns of n floats each (column c at values + c * n),
// a segment layout in CSR form (segment s owns entries offsets[s] ..
// offsets[s + 1] - 1 of perm, each the index of a value within a column;
// perm == nullptr is the identity), and out[c * S + s] = the sum over segment
// s of column c, in double.  An empty segment sums to 0.
//
// The sums accumulate in double: the backend's reduced pose system is the
// difference of two such sums of terms up to ~1e9 (Hpp and the cross term),
// which cancel, and a float accumulator's rounding there decides whether the
// factorisation succeeds and how far a map sharded over S shards strays from
// the same map on one shard.  Each float value converts to double exactly.
//
// The order, which the plain version (core/cuda_kernels.py:segment_sum_ref)
// fixes: entry j of a segment belongs to lane j % 32 of a warp; each lane adds
// its entries in turn into a partial starting from 0.0; then the 32 partials
// are added by the halving tree x_l = x_l + x_{l+h}, h = 16, 8, 4, 2, 1, and
// x_0 is the sum.  Every add rounds once (no contraction: -fmad=false).
//
// The schedule: one launch, whose blocks take one of two roles.
//
// * Short and empty segments (up to SHORT_MAX = 8 entries): a warp takes a
//   tile of 32 consecutive segments, one lane each, and reads their offsets
//   in one coalesced load.  A lane stages its segment's indices in shared
//   memory once (slot j of lane l at stage[j * 32 + l]) and reads them from
//   there for every column.  Its sum is the tree over its entries' partials
//   0.0 + v_j, evaluated over only the slots that exist: the warp-uniform
//   class N (the power of two at or above the tile's longest short segment,
//   1 to 8) unrolls the tree's last log2(N) levels in registers, and each add
//   whose right operand is a slot j >= len is skipped.  An empty segment's
//   lane writes 0.0.  A tile's lanes write their sums of one column together,
//   coalesced.  The lane's tree is exact up to 32 entries, but SHORT_MAX = 32
//   takes 74 registers (the 32-slot tree) against 40, which slows the
//   by-landmark sum from 0.022 to 0.031 ms on an NVIDIA H100 80GB HBM3 at
//   700 W (PERF.md section 6).
// * Long segments (more than SHORT_MAX entries), listed by the layout (count,
//   then ids: core/cuda_kernels.py:long_segments): each (segment, column)
//   pair is one warp's task, in the plain warp order: lane l adds entries l,
//   l + 32, ... (LONG_UNROLL loads in flight), then the shuffle tree.  The
//   tasks of one segment go to neighbouring warps of a block, so its indices
//   come from L1 after the first column's warp.  These blocks come first in
//   the grid, striding over the tasks, and leave at once when the layout has
//   no long segment.  They take the slots that the tile blocks leave (8 per
//   SM, at least 2): a layout of few segments (by keyframe: 1,024, 513 of
//   them long) spreads its tasks over the card, one of many (the cross
//   term's 2^20 cells) runs its tiles beside fewer long warps, whose
//   scattered gathers then keep more of their sectors in L2.
//
// Why each is exact against the plain version:
// * Long: the same lanes add the same entries in the same order, from 0.0,
//   and __shfl_xor_sync(h) adds the same pairs x_l + x_{l^h} = x_l + x_{l+h}.
// * Short (len <= 32): lane j of the plain warp holds exactly one entry, so
//   its partial is 0.0 + v_j; lanes j >= len hold +0.0.  Skipping an add
//   x + (+0.0) is exact when x is not -0.0 (and a NaN stays a NaN).  No node
//   is -0.0: a leaf 0.0 + v is +0.0 for v = -0.0 and v itself otherwise, and
//   a sum of two values of which neither is -0.0 is not -0.0 (an exact zero
//   rounds to +0.0; a nonzero exact sum of doubles is at least 2^-1074 in
//   magnitude and does not round to zero).  So the elided tree gives the
//   plain tree's bits.  tests/test_torch_segment_sum.py holds a numpy
//   transcription of this lane and of the whole launch against the plain
//   order.
// * Empty: the plain tree of 32 zeros is +0.0, which the lane writes.  The
//   wrapper allocates out with torch.empty: every segment is written here,
//   and no separate fill runs.
//
// What bounds it on an H100: the bytes.  Each entry's index and its C values
// are read once, the S + 1 offsets read once, and C doubles per segment
// written: 4 (C E + E + S + 1) + 8 C S bytes for E entries; one add per
// value.  At BASELINE config #5 on 4 shards (shard 0) that is 0.0144,
// 0.0163, 0.0488 and 0.0069 ms at 3.35 TB/s for the by-landmark (C = 5),
// by-keyframe (12), cross-term (9, 2^20 cells) and back-substitution (2)
// sums.  Measured on an NVIDIA H100 80GB HBM3 at 700 W (device time, 50
// calls in a CUDA graph; PERF.md section 6, row 9): 0.022, 0.024, 0.092 and
// 0.006 ms, 66, 69, 53 and ~110 % of those bounds (back-substitution's 23
// MB stay in L2 from call to call; 0.014 ms, 49 %, with L2 cold).  The
// values are gathered through perm: the cross term's cells take 16.7
// distinct 32-byte sectors per warp load of 32 values (4 if contiguous),
// so its loads move 4.2x its values' bytes, which is what holds it.

#include <cuda_runtime.h>

namespace {

constexpr int SEG_LANES = 32;                     // a warp
constexpr int SHORT_MAX = 8;                      // core/cuda_kernels.py SHORT_SEGMENT
constexpr int SEG_THREADS = 256;                  // 8 warps: 8 tiles or 8 long tasks at a time
constexpr int SEG_WARPS = SEG_THREADS / 32;
constexpr int LONG_UNROLL = 8;                    // a long task's loads in flight per lane
constexpr int LONG_SLOTS_PER_SM = 8;              // long blocks: the slots the tiles leave,
constexpr int LONG_MIN_PER_SM = 2;                // and at least this many per SM
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int entry(const int* __restrict__ perm, int j) {
  return perm != nullptr ? perm[j] : j;
}

static_assert((SHORT_MAX & (SHORT_MAX - 1)) == 0 && SHORT_MAX <= SEG_LANES,
              "a lane's tree is the last levels of the warp's");

// The tree's levels h = H, H / 2, ..., 1 over the slots of x, each add whose
// right operand is an absent slot (l + h >= len) skipped.  A template
// recursion, so that every index of x is a constant and x stays in registers.
template <int H>
__device__ __forceinline__ void tree_levels(double* x, int len) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int l = 0; l < H; ++l) {
      if (l + H < len) x[l] = x[l] + x[l + H];
    }
    tree_levels<H / 2>(x, len);
  }
}

// One lane's short segment of len <= N entries (len = 0: 0.0) in column col,
// its indices at idx[j * SEG_LANES]: the leaves 0.0 + v_j, then the levels.
template <int N>
__device__ __forceinline__ double lane_sum(const float* __restrict__ col, const int* idx,
                                           int len) {
  double x[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j] = j < len ? 0.0 + static_cast<double>(col[idx[j * SEG_LANES]]) : 0.0;
  }
  tree_levels<N / 2>(x, len);
  return x[0];
}

// Stage a lane's indices (slots j < len of N), then its sum of every column.
template <int N>
__device__ __forceinline__ void tile_columns(const float* __restrict__ values,
                                             const int* __restrict__ perm, long long n, int C,
                                             double* __restrict__ out, int S, int s, bool write,
                                             int start, int len, int* idx) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < len) idx[j * SEG_LANES] = entry(perm, start + j);
  }
  for (int c = 0; c < C; ++c) {
    const double sum = lane_sum<N>(values + static_cast<long long>(c) * n, idx, len);
    if (write) out[static_cast<long long>(c) * S + s] = sum;
  }
}

// The tile's class: the least power of two N >= its longest short segment.
template <int N>
__device__ __forceinline__ void tile_class(unsigned longest, const float* __restrict__ values,
                                           const int* __restrict__ perm, long long n, int C,
                                           double* __restrict__ out, int S, int s, bool write,
                                           int start, int len, int* idx) {
  if constexpr (N < SHORT_MAX) {
    if (longest > N) {
      tile_class<2 * N>(longest, values, perm, n, C, out, S, s, write, start, len, idx);
      return;
    }
  }
  tile_columns<N>(values, perm, n, C, out, S, s, write, start, len, idx);
}

// A warp's tile of 32 segments from s0: the short and empty ones.
__device__ __forceinline__ void short_tile(const float* __restrict__ values,
                                           const int* __restrict__ perm,
                                           const int* __restrict__ offsets,
                                           double* __restrict__ out, int C, long long n, int S,
                                           int s0, int* stage) {
  const int lane = threadIdx.x & 31;
  const bool mine = lane < S - s0;
  const int s = mine ? s0 + lane : s0;
  int start = 0, len = 0;
  if (mine) {
    start = offsets[s];
    len = offsets[s + 1] - start;
  }
  const bool write = mine && len <= SHORT_MAX;    // a long segment is a long task's
  if (!write) len = 0;
  const unsigned longest = __reduce_max_sync(FULL, static_cast<unsigned>(len));
  // a lane reads only the slots it writes
  tile_class<1>(longest, values, perm, n, C, out, S, s, write, start, len, stage + lane);
}

// Warp `warp` of `warps` takes the (long segment, column) tasks t = warp,
// warp + warps, ... of the layout's count * C, segment-major.
__device__ __forceinline__ void long_tasks(const float* __restrict__ values,
                                           const int* __restrict__ perm,
                                           const int* __restrict__ offsets,
                                           const int* __restrict__ long_list,
                                           double* __restrict__ out, int C, long long n, int S,
                                           int warp, int warps) {
  const int lane = threadIdx.x & 31;
  const int count = long_list[0];
  // < 2^31: each long segment holds more than SHORT_MAX of the C n < 2^31 values
  const int tasks = count * C;
  for (int t = warp; t < tasks; t += warps) {
    const int seg = long_list[1 + t / C];
    const int c = t % C;
    const int end = offsets[seg + 1];
    const float* col = values + static_cast<long long>(c) * n;
    double acc = 0.0;
    int j = offsets[seg] + lane;
    for (; j < end - (LONG_UNROLL - 1) * SEG_LANES; j += LONG_UNROLL * SEG_LANES) {
      float v[LONG_UNROLL];
#pragma unroll
      for (int u = 0; u < LONG_UNROLL; ++u) v[u] = col[entry(perm, j + u * SEG_LANES)];
#pragma unroll
      for (int u = 0; u < LONG_UNROLL; ++u) acc += static_cast<double>(v[u]);
    }
    for (; j < end; j += SEG_LANES) acc += static_cast<double>(col[entry(perm, j)]);
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) acc += __shfl_xor_sync(FULL, acc, h);
    if (lane == 0) out[static_cast<long long>(c) * S + seg] = acc;
  }
}

__global__ void __launch_bounds__(SEG_THREADS)
segment_sum_kernel(const float* __restrict__ values, const int* __restrict__ perm,
                   const int* __restrict__ offsets, const int* __restrict__ long_list,
                   double* __restrict__ out, const int C, const long long n, const int S,
                   const int long_blocks) {
  __shared__ int stage[SEG_WARPS * SHORT_MAX * SEG_LANES];
  const int warp = threadIdx.x >> 5;
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    long_tasks(values, perm, offsets, long_list, out, C, n, S,
               blockIdx.x * SEG_WARPS + warp, long_blocks * SEG_WARPS);
    return;
  }
  const long long s0 =
      (static_cast<long long>(blockIdx.x - long_blocks) * SEG_WARPS + warp) * SEG_LANES;
  if (s0 >= S) return;
  short_tile(values, perm, offsets, out, C, n, S, static_cast<int>(s0),
             stage + warp * SHORT_MAX * SEG_LANES);
}

}  // namespace

extern "C" {

// values: C columns of n floats; perm: offsets[S] entries (or nullptr for the
// identity); offsets: S + 1 non-decreasing ints from 0; long_list: S + 1 ints,
// the count of segments of more than 32 entries, then their ids; out: C x S
// doubles, every one written.
// Returns a cudaError_t; 1 (cudaErrorInvalidValue) for a negative size.
int segment_sum_launch(int device, const float* values, const int* perm, const int* offsets,
                       const int* long_list, double* out, int C, int n, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C < 0 || n < 0 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || S == 0) return 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tile_blocks =
      (static_cast<long long>(S) + SEG_THREADS - 1) / SEG_THREADS;   // a warp per 32 segments
  // the long blocks take the card's LONG_SLOTS_PER_SM slots that the tile
  // blocks leave, at least LONG_MIN_PER_SM per SM, and no more than the
  // tasks of min(S, n / (SHORT_MAX + 1)) long segments need
  long long long_blocks = static_cast<long long>(sms) * LONG_SLOTS_PER_SM - tile_blocks;
  if (long_blocks < static_cast<long long>(sms) * LONG_MIN_PER_SM) {
    long_blocks = static_cast<long long>(sms) * LONG_MIN_PER_SM;
  }
  const long long most_long = n / (SHORT_MAX + 1) < S ? n / (SHORT_MAX + 1) : S;
  if (long_blocks > (most_long * C + SEG_WARPS - 1) / SEG_WARPS) {
    long_blocks = (most_long * C + SEG_WARPS - 1) / SEG_WARPS;
  }
  segment_sum_kernel<<<static_cast<unsigned>(long_blocks + tile_blocks), SEG_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      values, perm, offsets, long_list, out, C, static_cast<long long>(n), S,
      static_cast<int>(long_blocks));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
