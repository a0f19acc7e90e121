// The device-decided systematic resample of the planes layout, for Hopper
// (sm_90a): the staircase of ancestors and the ancestor gather.
//
// Port-only kernels: no Pallas kernel stands behind them.  They replace the
// JAX package's resample under `lax.cond` (fastslam_tpu/core/kernels.py:
// _normalize_and_resample): its staircase, a scatter-max and an
// `associative_scan` max (grid_staircase_indices), and its gather
// (resample_planes_state).  The port ran that as some thirty ATen ops on
// every tick or chunk whether or not a resample was due: the int64 cumulative
// sum, the staircase's scatter_reduce and cummax, an identity gather of the
// whole state, and a copy back of it (core/kernels.py before this file).
//
// The decision, neff < threshold * P, stays in device memory, a bool the
// caller computed.  Every kernel here reads it first and returns at once
// where it is false: a tick or chunk with no resample due moves no state byte.
//
// The staircase (resample_staircase_launch, three kernels), bit for bit the
// ATen ops of core/kernels.py:fixed_order_cumsum and grid_staircase_indices
// on the card:
// 1. staircase_tile_sums: each block sums q_j = rint(w_j * 2^48) over its
//    SCAN_TILE weights, in int64 (exact in any order: the weights sum to
//    about 1, far below 2^15).
// 2. staircase_counts: each block adds the tile sums before its own (the
//    carry), scans its tile, and from each inclusive sum S_j takes
//    cum_j = float(double(S_j) * 2^-48) and the count s_j of grid points
//    u0 + m / P at or below cum_j: ceil((cum_j - u0) * P) clamped to
//    [0, P], then two corrections each way against the grid.  Each op is
//    the float32 op ATen runs there; a CUDA tensor divided by a host scalar
//    is multiplied by the scalar's float32 reciprocal, so a grid point is
//    u0 + float(m) * (1.0f / P).
// 3. staircase_ancestors: idx[m] = the first j with s_j > m, and P - 1 where
//    no s_j exceeds m (past s_{P-1}: the undersum tail): a binary search
//    over the counts, one thread per m.
// Why 3 equals the scatter-max and prefix max: the grid is non-decreasing in
// m, and two corrections each way bring every count to the exact number of
// grid points at or below cum_j (the closed form is within one of it, and the
// float32 grid within 2e-7 of the exact one, far inside its spacing 1 / P),
// so s is non-decreasing.  Each j with s_j > s_{j-1} then owns the run
// [s_{j-1}, s_j), the runs tile [0, s_{P-1}) in order, and the largest j
// scattered at or before m, which the prefix max takes, is the first j with
// s_j > m; past s_{P-1} the tail's P - 1 is the largest.
// tests/test_torch_resample.py holds the plain version (the same search,
// torch.searchsorted) to grid_staircase_indices bit for bit.
//
// The gather (resample_gather_launch, two launches of gather_kernel): the
// first gathers every buffer of the state along the particle axis into a
// scratch of the same shape, dst[r, m] = src[r, idx[m]]; the second copies
// the scratch back into the caller's buffers (idx = nullptr: the identity),
// so the caller keeps its own tensors and no copy follows.  A buffer is
// `rows` rows of P particles of `width` 32-bit words: an [L, P] plane is L
// rows of width 1, the poses [P, 3] one row of width 3, the counts and
// weights one row of width 1.  A task is one tile of GATHER_THREADS
// particles of up to GATHER_ROWS rows of one buffer; a thread loads its
// ancestor once and keeps GATHER_ROWS loads in flight.  idx is
// non-decreasing, so a warp's reads fall on few sectors, and its writes are
// coalesced.  Gathering in place would race: a column can be read as an
// ancestor after another thread has overwritten it.
//
// What bounds them on an H100: the bytes.  At P = 100,000, L = 64 in
// production (five planes, poses, counts) the state is 129.6 MB, so a due
// resample needs one read and one write of it, 0.0774 ms at 3.35 TB/s, and
// the staircase reads 0.4 MB of weights and writes 0.8 MB of indices
// (0.0004 ms); a tick with no resample due needs nothing.  The gather and
// its copy back move twice that bound, and the staircase is a few launches'
// latency: both are paid on due ticks only (7-15 % of the online ticks).

#include <cuda_runtime.h>

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 16;                           // weights per thread
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;     // core/cuda_kernels.py RESAMPLE_SCAN_TILE
constexpr int SEARCH_THREADS = 256;
constexpr int GATHER_THREADS = 256;
constexpr int GATHER_ROWS = 16;                          // rows of one task, loads in flight
constexpr int MAX_BUFFERS = 10;                          // core/cuda_kernels.py RESAMPLE_MAX_BUFFERS
constexpr int BLOCKS_PER_SM = 8;                         // grid-stride beyond this
constexpr double GRID_SCALE = 281474976710656.0;         // 2^48
constexpr double GRID_UNIT = 1.0 / GRID_SCALE;           // 2^-48, exact
constexpr unsigned FULL = 0xffffffffu;

struct GatherBuffers {
  const unsigned* src[MAX_BUFFERS];
  unsigned* dst[MAX_BUFFERS];
  int rows[MAX_BUFFERS];
  int width[MAX_BUFFERS];
  int task_end[MAX_BUFFERS];   // the tasks of buffers 0 .. b, inclusive
  int count;
};

// torch.round(w.double() * 2^48).long(): round half to even, as nearbyint.
// Summed as unsigned, so that an overflow wraps as torch's int64 cumsum does.
__device__ __forceinline__ unsigned long long quantum(float w) {
  return static_cast<unsigned long long>(
      static_cast<long long>(rint(static_cast<double>(w) * GRID_SCALE)));
}

// The sum of v over the block, in every thread; scratch holds a value per warp.
__device__ __forceinline__ unsigned long long block_sum(unsigned long long v,
                                                        unsigned long long* scratch) {
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) v += __shfl_xor_sync(FULL, v, h);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long total = 0;
  for (int w = 0; w < SCAN_THREADS / 32; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// core/kernels.py:grid_staircase_indices's grid(m) as ATen evaluates it on
// the card: u0 + m.float() * (1 / n).
__device__ __forceinline__ float grid_point(float u0, int m, float inv_n) {
  return u0 + static_cast<float>(m) * inv_n;
}

// core/kernels.py:grid_counts of one inclusive sum.
__device__ __forceinline__ int grid_count(unsigned long long sum, float u0, int n, float nf,
                                          float inv_n) {
  const float cum =
      static_cast<float>(static_cast<double>(static_cast<long long>(sum)) * GRID_UNIT);
  long long s = static_cast<long long>(ceilf((cum - u0) * nf));
  s = s < 0 ? 0 : (s > n ? n : s);
  int c = static_cast<int>(s);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (c > 0 && grid_point(u0, c - 1, inv_n) > cum) --c;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (c < n && grid_point(u0, c, inv_n) <= cum) ++c;
  }
  return c;
}

__global__ void __launch_bounds__(SCAN_THREADS)
staircase_tile_sums(const float* __restrict__ weights, const unsigned char* __restrict__ due,
                    const int P, unsigned long long* __restrict__ tile_sums) {
  if (!*due) return;
  __shared__ unsigned long long scratch[SCAN_THREADS / 32];
  const long long base = static_cast<long long>(blockIdx.x) * SCAN_TILE + threadIdx.x;
  unsigned long long acc = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const long long j = base + k * SCAN_THREADS;     // coalesced across the warp
    if (j < P) acc += quantum(weights[j]);
  }
  const unsigned long long total = block_sum(acc, scratch);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(SCAN_THREADS)
staircase_counts(const float* __restrict__ weights, const float* __restrict__ u0p,
                 const unsigned char* __restrict__ due, const int P,
                 const unsigned long long* __restrict__ tile_sums, int* __restrict__ counts) {
  if (!*due) return;
  __shared__ unsigned long long scratch[SCAN_THREADS / 32];
  unsigned long long carry = 0;
  for (unsigned t = threadIdx.x; t < blockIdx.x; t += SCAN_THREADS) carry += tile_sums[t];
  carry = block_sum(carry, scratch);
  // this thread's SCAN_ITEMS consecutive weights, scanned in turn
  const long long j0 =
      static_cast<long long>(blockIdx.x) * SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  unsigned long long incl[SCAN_ITEMS];
  unsigned long long run = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    if (j0 + k < P) run += quantum(weights[j0 + k]);
    incl[k] = run;
  }
  // the threads before this one: a warp scan, then the warps before
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long warp_incl = run;
#pragma unroll
  for (int h = 1; h < 32; h <<= 1) {
    const unsigned long long up = __shfl_up_sync(FULL, warp_incl, h);
    if (lane >= h) warp_incl += up;
  }
  if (lane == 31) scratch[warp] = warp_incl;
  __syncthreads();
  unsigned long long before = carry + (warp_incl - run);
  for (int w = 0; w < warp; ++w) before += scratch[w];
  const float u0 = *u0p;
  const float nf = static_cast<float>(P);
  const float inv_n = 1.0f / nf;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    if (j0 + k < P) counts[j0 + k] = grid_count(before + incl[k], u0, P, nf, inv_n);
  }
}

__global__ void __launch_bounds__(SEARCH_THREADS)
staircase_ancestors(const int* __restrict__ counts, const unsigned char* __restrict__ due,
                    const int P, long long* __restrict__ idx) {
  if (!*due) return;
  const long long step = static_cast<long long>(gridDim.x) * SEARCH_THREADS;
  for (long long m = static_cast<long long>(blockIdx.x) * SEARCH_THREADS + threadIdx.x; m < P;
       m += step) {
    int lo = 0;
    int hi = P;                       // the first j in [lo, hi) with counts[j] > m
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (__ldg(counts + mid) > m) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    idx[m] = lo < P ? lo : P - 1;
  }
}

// dst[r, m] = src[r, idx[m]] for every buffer (idx == nullptr: src[r, m]).
__global__ void __launch_bounds__(GATHER_THREADS)
gather_kernel(const GatherBuffers bufs, const long long* __restrict__ idx,
              const unsigned char* __restrict__ due, const int P, const int tiles) {
  if (!*due) return;
  const int total = bufs.task_end[bufs.count - 1];
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int b = 0;
    while (t >= bufs.task_end[b]) ++b;
    const int local = t - (b > 0 ? bufs.task_end[b - 1] : 0);
    const int m = (local % tiles) * GATHER_THREADS + threadIdx.x;
    if (m >= P) continue;
    const long long from = idx != nullptr ? idx[m] : m;
    const int width = bufs.width[b];
    const int r0 = (local / tiles) * GATHER_ROWS;
    const int nrows = min(bufs.rows[b] - r0, GATHER_ROWS);
    const long long row = static_cast<long long>(P) * width;
    const unsigned* src = bufs.src[b] + r0 * row;
    unsigned* dst = bufs.dst[b] + r0 * row;
    if (width == 1) {
      unsigned v[GATHER_ROWS];
#pragma unroll
      for (int k = 0; k < GATHER_ROWS; ++k) {
        if (k < nrows) v[k] = src[k * row + from];
      }
#pragma unroll
      for (int k = 0; k < GATHER_ROWS; ++k) {
        if (k < nrows) dst[k * row + m] = v[k];
      }
    } else {
      for (int k = 0; k < nrows; ++k) {
        for (int e = 0; e < width; ++e) {
          dst[k * row + static_cast<long long>(m) * width + e] = src[k * row + from * width + e];
        }
      }
    }
  }
}

cudaError_t sm_count(int device, int* sms) {
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

extern "C" {

// weights: P floats, exp of the normalized log-weights; u0: one float; due:
// one bool; tile_sums: ceil(P / SCAN_TILE) int64; counts: P ints; idx: P
// int64, written only where *due.  Returns a cudaError_t; 1
// (cudaErrorInvalidValue) for a negative P.
int resample_staircase_launch(int device, const float* weights, const float* u0,
                              const unsigned char* due, long long* tile_sums, int* counts,
                              long long* idx, int P, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned tiles =
      static_cast<unsigned>((static_cast<long long>(P) + SCAN_TILE - 1) / SCAN_TILE);
  auto* sums = reinterpret_cast<unsigned long long*>(tile_sums);
  staircase_tile_sums<<<tiles, SCAN_THREADS, 0, s>>>(weights, due, P, sums);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  staircase_counts<<<tiles, SCAN_THREADS, 0, s>>>(weights, u0, due, P, sums, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (static_cast<long long>(P) + SEARCH_THREADS - 1) / SEARCH_THREADS;
  if (blocks > static_cast<long long>(sms) * BLOCKS_PER_SM) {
    blocks = static_cast<long long>(sms) * BLOCKS_PER_SM;
  }
  staircase_ancestors<<<static_cast<unsigned>(blocks), SEARCH_THREADS, 0, s>>>(counts, due, P,
                                                                               idx);
  return static_cast<int>(cudaGetLastError());
}

// buffers, scratch: count device pointers (host arrays) to buffers of rows[b]
// x P x widths[b] 32-bit words, each buffer's scratch of the same size; idx: P
// int64 ancestors; due: one bool.  Where *due, gathers every buffer into its
// scratch by idx, then copies the scratch back; else both launches return at
// once.  Returns a cudaError_t; 1 (cudaErrorInvalidValue) for a count outside
// [1, MAX_BUFFERS], a negative size, or more than 2^31 - 1 tasks.
int resample_gather_launch(int device, void* const* buffers, void* const* scratch,
                           const int* rows, const int* widths, int count,
                           const long long* idx, const unsigned char* due, int P,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count < 1 || count > MAX_BUFFERS || P < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0) return 0;
  const long long tiles = (static_cast<long long>(P) + GATHER_THREADS - 1) / GATHER_THREADS;
  GatherBuffers gather;
  GatherBuffers back;
  long long tasks = 0;
  for (int b = 0; b < count; ++b) {
    if (rows[b] < 1 || widths[b] < 1) return static_cast<int>(cudaErrorInvalidValue);
    tasks += (rows[b] + GATHER_ROWS - 1) / GATHER_ROWS * tiles;
    if (tasks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    gather.src[b] = static_cast<const unsigned*>(buffers[b]);
    gather.dst[b] = static_cast<unsigned*>(scratch[b]);
    back.src[b] = static_cast<const unsigned*>(scratch[b]);
    back.dst[b] = static_cast<unsigned*>(buffers[b]);
    gather.rows[b] = back.rows[b] = rows[b];
    gather.width[b] = back.width[b] = widths[b];
    gather.task_end[b] = back.task_end[b] = static_cast<int>(tasks);
  }
  gather.count = back.count = count;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = tasks;
  if (blocks > static_cast<long long>(sms) * BLOCKS_PER_SM) {
    blocks = static_cast<long long>(sms) * BLOCKS_PER_SM;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather_kernel<<<static_cast<unsigned>(blocks), GATHER_THREADS, 0, s>>>(
      gather, idx, due, P, static_cast<int>(tiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_kernel<<<static_cast<unsigned>(blocks), GATHER_THREADS, 0, s>>>(
      back, nullptr, due, P, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
