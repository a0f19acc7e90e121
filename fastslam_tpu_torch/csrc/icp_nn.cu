// Nearest-neighbour correspondences of ICP, for Hopper (sm_90a).
//
// Replaces fastslam_tpu/core/pallas_kernels.py:icp_correspondences (body
// _nn_kernel): for each source point, the closest valid target point of the
// same cloud pair.  It computes what proposal/icp.py:nearest_neighbors
// computes: d2 = dx*dx + dy*dy, +inf on invalid targets, the FIRST index at
// the minimum, and sqrt of the minimum.  An all-invalid target cloud gives
// index 0 and distance +inf, as jnp.argmin does.
//
// Design: one thread per source point, one block per (cloud pair, tile of
// 128 source points).  The pair index is grid.x (up to 2^31 - 1 pairs); a
// cloud with more than 65535 source tiles is walked by a block-uniform loop
// over grid.y, so one launch takes any batch.  The pair's target points and
// validity flags are staged through shared memory in tiles of TGT_TILE
// points, so any target size works.  Each thread keeps a running best and index and replaces them
// only on a strictly smaller distance, so a tie keeps the first index.
// Threads past the ragged end of the source cloud help stage the tiles and
// write nothing (the TPU wrapper padded the source with 1e30 instead).
//
// What bounds it on an H100: per pair it reads N + Mt points and writes N
// distances and indices, a few kB, while it does N * Mt distance evaluations
// (5 flops each).  At the ICP shapes (N = Mt = 180 beams, ~600 pairs) that is
// ~2.7 MB against ~97 MFLOP: about 1.4 us of compute at the f32 peak, far
// below the cost of a launch.  The kernel is launch-bound; the shared-memory
// tile keeps the target reads off the memory bus either way.
//
// Built with -fmad=false and IEEE sqrtf, so it rounds like the plain PyTorch
// version (core/cuda_kernels.py:icp_correspondences_ref) bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NN_THREADS = 128;
constexpr int TGT_TILE = 1024;

__global__ void icp_nn_kernel(const float* __restrict__ source,
                              const float* __restrict__ target,
                              const unsigned char* __restrict__ target_valid,
                              float* __restrict__ dist, int* __restrict__ idx,
                              const int N, const int Mt) {
  __shared__ float tx_s[TGT_TILE];
  __shared__ float ty_s[TGT_TILE];
  __shared__ unsigned char tv_s[TGT_TILE];

  const size_t pair = blockIdx.x;
  const float* src = source + pair * 2 * static_cast<size_t>(N);
  const float* tgt = target + pair * 2 * static_cast<size_t>(Mt);
  const unsigned char* tval = target_valid + pair * static_cast<size_t>(Mt);
  const int tiles = (N + NN_THREADS - 1) / NN_THREADS;

  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int n = tile * NN_THREADS + threadIdx.x;
    const bool active = n < N;
    float sx = 0.0f, sy = 0.0f;
    if (active) {
      sx = src[2 * static_cast<size_t>(n)];
      sy = src[2 * static_cast<size_t>(n) + 1];
    }
    float best = __int_as_float(0x7f800000);  // +inf
    int best_idx = 0;

    for (int base = 0; base < Mt; base += TGT_TILE) {
      const int count = min(TGT_TILE, Mt - base);
      __syncthreads();  // the previous tile is no longer read
      for (int j = threadIdx.x; j < count; j += NN_THREADS) {
        tx_s[j] = tgt[2 * static_cast<size_t>(base + j)];
        ty_s[j] = tgt[2 * static_cast<size_t>(base + j) + 1];
        tv_s[j] = tval[base + j];
      }
      __syncthreads();
      if (!active) continue;
      for (int j = 0; j < count; ++j) {
        if (!tv_s[j]) continue;
        const float dx = sx - tx_s[j];
        const float dy = sy - ty_s[j];
        const float d2 = dx * dx + dy * dy;
        if (d2 < best) {
          best = d2;
          best_idx = base + j;
        }
      }
    }
    if (active) {
      const size_t out = pair * static_cast<size_t>(N) + n;
      dist[out] = sqrtf(best);
      idx[out] = best_idx;
    }
  }
}

}  // namespace

extern "C" {

int icp_correspondences_launch(int device, const float* source, const float* target,
                               const unsigned char* target_valid, float* dist,
                               int* idx, int B, int N, int Mt, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || N == 0) return 0;
  const int tiles = (N + NN_THREADS - 1) / NN_THREADS;
  const dim3 grid(B, tiles < 65535 ? tiles : 65535);
  icp_nn_kernel<<<grid, NN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      source, target, target_valid, dist, idx, N, Mt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
