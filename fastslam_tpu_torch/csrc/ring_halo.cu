// Ring halo exchange of the distributed resampler, for Hopper (sm_90a).
//
// Replaces fastslam_tpu/parallel/ring_resample.py:ring_halo_exchange (body
// _exchange_kernel): every shard s of a ring of S shards sends its packed
// particle block (P_local x D float32, D = 3 + 1 + 2L + 4L + 1) to both ring
// neighbours, so that shard s receives left_s = block_{s-1} and
// right_s = block_{s+1}, indices mod S.  The TPU kernel is one remote-DMA
// kernel per chip: a neighbour barrier on a semaphore, then both DMAs (clockwise
// into the right neighbour's left buffer, counter-clockwise into the left
// neighbour's right buffer) started before either is waited on.
//
// Design, for a ring whose shards all lie on one card: one launch moves the
// whole ring.  The grid is (element tiles, S shards); each thread loads 16
// bytes of its shard's block once and stores them twice, into left_{s+1} and
// right_{s-1}, so both directions are in flight together and each source byte
// is read once.  A block is a flat array of n = P_local * D floats; the
// float4 body covers the first 4 * (n / 4) of them and the first grid column
// copies the scalar tail.  The 3S block pointers travel by value in the
// parameter struct (at most RING_MAX_SHARDS shards).  S = 1 copies the block
// into both of its own buffers; S = 2 writes the other shard's block into two
// distinct buffers.  Wrapped neighbours (shard 0's left is shard S - 1) are
// moved like any other: the resampler's window test rejects their indices.
//
// Stream order stands in for the TPU kernel's neighbour barrier: the blocks
// are written before the launch on the same stream, and the buffers are read
// after it.  The cross-card form needs peer pointers (NVLink) and a flag
// barrier in device memory between the cards; it is queued (ROADMAP).
//
// What bounds it on an H100: the bytes.  It reads S * n * 4 bytes and writes
// twice that; at P = 100,000, L = 64 (S * n = 38.9M floats) that is 467 MB,
// 0.139 ms at 3.35 TB/s.  It does no arithmetic.  The 16-byte loads and
// stores, coalesced across the warp, are what the design does about it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int RING_MAX_SHARDS = 64;
constexpr int RING_THREADS = 256;
constexpr long long RING_MAX_TILES = 1 << 20;   // grid-stride beyond this

struct RingBlocks {
  const float* src[RING_MAX_SHARDS];
  float* left[RING_MAX_SHARDS];
  float* right[RING_MAX_SHARDS];
};

__global__ void __launch_bounds__(RING_THREADS)
ring_halo_kernel(const RingBlocks blocks, const int S, const long long n) {
  const int s = blockIdx.y;
  // my block is the left halo of shard s + 1 and the right halo of shard s - 1
  const int to_left = s + 1 == S ? 0 : s + 1;
  const int to_right = s == 0 ? S - 1 : s - 1;
  const float* src = blocks.src[s];
  float* left = blocks.left[to_left];
  float* right = blocks.right[to_right];

  const long long n4 = n / 4;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  float4* left4 = reinterpret_cast<float4*>(left);
  float4* right4 = reinterpret_cast<float4*>(right);
  const long long stride = static_cast<long long>(gridDim.x) * RING_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * RING_THREADS + threadIdx.x;
       i < n4; i += stride) {
    const float4 v = __ldg(src4 + i);
    left4[i] = v;
    right4[i] = v;
  }
  if (blockIdx.x == 0) {
    for (long long i = 4 * n4 + threadIdx.x; i < n; i += RING_THREADS) {
      const float v = src[i];
      left[i] = v;
      right[i] = v;
    }
  }
}

}  // namespace

extern "C" {

// src, left, right: host arrays of S device pointers, each to a block of n
// floats aligned to 16 bytes; left[s] and right[s] receive the blocks of
// shards s - 1 and s + 1 (mod S).  Returns a cudaError_t; 1
// (cudaErrorInvalidValue) for S outside [1, RING_MAX_SHARDS].
int ring_halo_exchange_launch(int device, const float* const* src, float* const* left,
                              float* const* right, int S, int n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S < 1 || S > RING_MAX_SHARDS || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  RingBlocks blocks;
  for (int s = 0; s < S; ++s) {
    blocks.src[s] = src[s];
    blocks.left[s] = left[s];
    blocks.right[s] = right[s];
  }
  const long long n4 = n / 4;
  long long tiles = (n4 + RING_THREADS - 1) / RING_THREADS;
  if (tiles < 1) tiles = 1;                       // the tail alone
  if (tiles > RING_MAX_TILES) tiles = RING_MAX_TILES;
  const dim3 grid(static_cast<unsigned>(tiles), S);
  ring_halo_kernel<<<grid, RING_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      blocks, S, static_cast<long long>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
