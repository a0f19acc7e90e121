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
// repeats: one warp per segment; lane l adds the segment's entries l, l + 32,
// l + 64, ... into a register starting from 0.0, in that order; then the 32
// lane partials are added by the shuffle tree x_l += x_{l ^ h} for h = 16, 8,
// 4, 2, 1, and lane 0 stores x_0.  Every add rounds once (no contraction:
// -fmad=false), as the plain version's.
//
// What bounds it on an H100: the bytes.  Each entry's index and its C values
// are read once, and C doubles per segment written; there is one add per
// value.  At the backend's 1.1M-landmark graph the widest call reads 9 columns
// of ~1.1M pair values per shard and writes 9 x 2^20 cell sums: ~120 MB, ~36
// us at 3.35 TB/s.  Consecutive lanes read consecutive entries of perm, and
// the values they index are gathered; the entries of a segment are a sorted
// run of a stable sort, so neighbouring lanes mostly gather neighbouring
// values, which is what the design does about the gather.  Segments of the
// landmark layout hold ~2 entries, so 30 of a warp's lanes idle there; an
// empty segment (most of the 2^20 cells) reads its offsets and stops, its
// zeros written by the caller's memset: the simple, exact layout first
// (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int SEG_THREADS = 256;                 // 8 warps, 8 segments per block
constexpr int SEG_WARPS = SEG_THREADS / 32;

__global__ void __launch_bounds__(SEG_THREADS)
segment_sum_kernel(const float* __restrict__ values, const int* __restrict__ perm,
                   const int* __restrict__ offsets, double* __restrict__ out, const int C,
                   const long long n, const int S) {
  const int lane = threadIdx.x & 31;
  const long long seg_stride = static_cast<long long>(gridDim.x) * SEG_WARPS;
  for (long long s = static_cast<long long>(blockIdx.x) * SEG_WARPS + (threadIdx.x >> 5);
       s < S; s += seg_stride) {
    const int start = offsets[s];
    const int end = offsets[s + 1];
    if (start == end) continue;    // out holds zeros: the tree of zeros is +0.0
    for (int c = 0; c < C; ++c) {
      const float* col = values + static_cast<long long>(c) * n;
      double acc = 0.0;
      for (int j = start + lane; j < end; j += 32) {
        acc += static_cast<double>(col[perm != nullptr ? perm[j] : j]);
      }
#pragma unroll
      for (int h = 16; h >= 1; h >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, h);
      }
      if (lane == 0) out[static_cast<long long>(c) * S + s] = acc;
    }
  }
}

}  // namespace

extern "C" {

// values: C columns of n floats; perm: offsets[S] entries (or nullptr for the
// identity); offsets: S + 1 non-decreasing ints from 0; out: C x S doubles,
// zero on entry (empty segments are not written).
// Returns a cudaError_t; 1 (cudaErrorInvalidValue) for a negative size.
int segment_sum_launch(int device, const float* values, const int* perm, const int* offsets,
                       double* out, int C, int n, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C < 0 || n < 0 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || S == 0) return 0;
  long long blocks = (static_cast<long long>(S) + SEG_WARPS - 1) / SEG_WARPS;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;   // grid-stride beyond this
  segment_sum_kernel<<<static_cast<unsigned>(blocks), SEG_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      values, perm, offsets, out, C, static_cast<long long>(n), S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
