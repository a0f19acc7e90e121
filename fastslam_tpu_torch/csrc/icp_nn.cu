// ICP on Hopper (sm_90a): the nearest-neighbour search, and the whole
// point-to-line loop around it.
//
// Replaces fastslam_tpu/core/pallas_kernels.py:icp_correspondences (body
// _nn_kernel): for each source point, the closest valid target point of the
// same cloud pair, as proposal/icp.py:nearest_neighbors computes it:
// d2 = dx*dx + dy*dy, +inf on invalid targets, the FIRST index at the
// minimum, and sqrt of the minimum; an all-invalid target cloud gives index
// 0 and distance +inf, as jnp.argmin does.  icp_point_to_line_kernel runs
// the batched while-loop of fastslam_tpu/proposal/icp.py:icp_point_to_line
// around that search, every iteration of every pair in one launch.
//
// The search (nn_search): G lanes per source point split the target scan,
// lane g taking targets g, g + G, ... of a tile staged in shared memory.
// Each lane keeps the smallest packed key (bits(d2) << 32) | index; d2 >= 0,
// so the integer order is the value order, and equal distances go to the
// lower index.  The lanes take the minimum by __shfl_xor_sync (lanes_min).
// A minimum of integers does not depend on the order, so the split search
// gives the serial first-index argmin bit for bit.  Invalid targets are
// skipped, so they count as +inf; the running key starts at (+inf, 0).
//
// icp_nn_kernel: G = 4 lanes per point, 32 points per block of 128 threads,
// one block per (cloud pair, tile of 32 source points).  The pair index is
// grid.x (up to 2^31 - 1 pairs); a cloud with more than 65535 source tiles
// is walked by a block-uniform loop over grid.y.  Targets go through shared
// memory in tiles of TGT_TILE points, so any target size works.
//
// icp_point_to_line_kernel: one block per cloud pair.  The pair's target,
// its normals and both validity flags sit in shared memory (staged once per
// call when they fit one tile of TGT_TILE points, else tile by tile for
// every pass of source points).  The block keeps the moved source and the
// per-point terms of the normal equations in shared memory (or, past
// kPointSmemBytes, in a scratch row of device memory the wrapper gives it).
// Per iteration it moves nothing to the host:
//   1. for every source point, nn_search, then the gathered target q and
//      normal n, w = source valid * normal valid, r = (s - q) . n and
//      J = [s x n, n_x, n_y], and the eleven terms w J_a J_b (six), w J_a r
//      (three), w * dist and w;
//   2. the eleven sums by a fixed-order tree (zeros pad the point axis to a
//      power of two P2, then x[i] += x[i + h] for h = P2/2, ..., 1: in
//      shared memory down to 32 partials, then by warp shuffles), the order
//      of core/kernels.py:tree_sum;
//   3. one thread solves the 3x3 system by cofactors (|det| > 1e-12 clamp),
//      and updates the carry (theta_total += theta, t_total = R(theta)
//      t_total + t, the mean error, converged = |prev_err - err| < tol, the
//      iteration count);
//   4. every thread moves its source points by R(theta) and t.
// The pair stops at convergence or at max_iter, decided on the device.
// Rotations take sinf/cosf of theta, which equal torch.sin/torch.cos of a
// CUDA tensor bit for bit (chip_smoke.py phase 10 checks 1e8 values).
//
// What bounds them on an H100: per pair and iteration N x Mt distance
// evaluations (6 operations each) against a few kB read; at the ICP shapes
// (N = Mt = 180 beams, ~600 pairs, ~5 iterations) ~0.6 GFLOP, ~9 us at the
// f32 peak.  The search is latency-bound: a lane's scan is a dependent
// chain of shared-memory loads, which the lanes split G ways.  The old
// design launched the search once per iteration, with ~45 eager ops and a
// host sync every 2 iterations around it; the fused kernel launches once
// per call.
//
// Built with -fmad=false, IEEE division and sqrtf, so both kernels round
// like the plain PyTorch versions (core/cuda_kernels.py:
// icp_correspondences_ref, icp_point_to_line_ref) bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NN_THREADS = 128;
constexpr int NN_LANES = 4;           // lanes per source point in icp_nn_kernel
constexpr int TGT_TILE = 1024;        // targets staged per shared-memory tile
constexpr int kSums = 11;             // w J J (6), w J r (3), w dist, w
constexpr int kPointSmemBytes = 65536;  // per-point arrays in shared memory up to this
constexpr int kSmemOptInLimit = 232448;
constexpr unsigned long long kNoTarget = 0x7F80000000000000ull;  // (+inf, index 0)

__device__ __forceinline__ unsigned group_mask(const int G) {
  const int lane = threadIdx.x & 31;
  return (G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u)) << (lane & ~(G - 1));
}

// Lane g of a point's G lanes scans targets g, g + G, ... of a staged tile
// (`count` targets from index `base`), keeping the smallest packed key.
__device__ __forceinline__ unsigned long long nn_search(
    const float sx, const float sy, const float* tx, const float* ty, const int* flags,
    const int count, const int base, const int g, const int G, unsigned long long best) {
  for (int j = g; j < count; j += G) {
    if (!(flags[j] & 1)) continue;
    const float dx = sx - tx[j];
    const float dy = sy - ty[j];
    const float d2 = dx * dx + dy * dy;
    const unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(d2)) << 32)
        | static_cast<unsigned>(base + j);
    best = key < best ? key : best;
  }
  return best;
}

// the smallest key of a point's G lanes, on every lane
__device__ __forceinline__ unsigned long long lanes_min(unsigned long long best, const int G,
                                                        const unsigned lanes) {
  for (int off = 1; off < G; off <<= 1) {
    const unsigned long long other = __shfl_xor_sync(lanes, best, off);
    best = other < best ? other : best;
  }
  return best;
}

__device__ __forceinline__ float key_dist(const unsigned long long key) {
  return sqrtf(__uint_as_float(static_cast<unsigned>(key >> 32)));
}

// Stage targets base .. base + count - 1 of a pair: points, flags (bit 0
// target valid, bit 1 normal valid) and, when given, normals.  Every thread
// of the block takes part; no barrier.
__device__ __forceinline__ void stage_targets(
    const float* __restrict__ tgt, const unsigned char* __restrict__ tval,
    const float* __restrict__ nrm, const unsigned char* __restrict__ nval, const int base,
    const int count, float* tx, float* ty, float* nx, float* ny, int* flags) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const size_t q = static_cast<size_t>(base) + j;
    tx[j] = tgt[2 * q];
    ty[j] = tgt[2 * q + 1];
    int f = tval[q] ? 1 : 0;
    if (nrm != nullptr) {
      nx[j] = nrm[2 * q];
      ny[j] = nrm[2 * q + 1];
      f |= nval[q] ? 2 : 0;
    }
    flags[j] = f;
  }
}

__global__ void icp_nn_kernel(const float* __restrict__ source,
                              const float* __restrict__ target,
                              const unsigned char* __restrict__ target_valid,
                              float* __restrict__ dist, int* __restrict__ idx,
                              const int N, const int Mt) {
  __shared__ float tx_s[TGT_TILE];
  __shared__ float ty_s[TGT_TILE];
  __shared__ int fl_s[TGT_TILE];

  const size_t pair = blockIdx.x;
  const float* src = source + pair * 2 * static_cast<size_t>(N);
  const float* tgt = target + pair * 2 * static_cast<size_t>(Mt);
  const unsigned char* tval = target_valid + pair * static_cast<size_t>(Mt);
  constexpr int per_tile = NN_THREADS / NN_LANES;
  const int g = threadIdx.x & (NN_LANES - 1);
  const unsigned lanes = group_mask(NN_LANES);
  const int tiles = (N + per_tile - 1) / per_tile;

  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int n = tile * per_tile + static_cast<int>(threadIdx.x) / NN_LANES;
    const bool active = n < N;
    float sx = 0.0f, sy = 0.0f;
    if (active) {
      sx = src[2 * static_cast<size_t>(n)];
      sy = src[2 * static_cast<size_t>(n) + 1];
    }
    unsigned long long best = kNoTarget;
    for (int base = 0; base < Mt; base += TGT_TILE) {
      const int count = min(TGT_TILE, Mt - base);
      __syncthreads();  // the previous tile is no longer read
      stage_targets(tgt, tval, nullptr, nullptr, base, count, tx_s, ty_s, nullptr, nullptr,
                    fl_s);
      __syncthreads();
      if (active) best = nn_search(sx, sy, tx_s, ty_s, fl_s, count, base, g, NN_LANES, best);
    }
    best = lanes_min(best, NN_LANES, lanes);
    if (active && g == 0) {
      const size_t out = pair * static_cast<size_t>(N) + n;
      dist[out] = key_dist(best);
      idx[out] = static_cast<int>(static_cast<unsigned>(best));
    }
  }
}

// x[i] += x[i + h] for h = P2 / 2, ..., 1 on each of the kSums rows of
// `red` ([kSums][P2], zeros past N): shared (or device) memory while more
// than 32 partials remain, then one warp per row by shuffles.  Ends with
// the sums in `out` and a barrier.
__device__ __forceinline__ void tree_sums(float* red, const int P2, float* out) {
  for (int h = P2 / 2; h >= 32; h >>= 1) {
    for (int e = threadIdx.x; e < kSums * h; e += blockDim.x) {
      const int k = e / h;
      const int i = e - k * h;
      red[k * P2 + i] = red[k * P2 + i] + red[k * P2 + i + h];
    }
    __syncthreads();
  }
  const int len = P2 < 32 ? P2 : 32;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int k = threadIdx.x >> 5; k < kSums; k += warps) {
    float v = lane < len ? red[k * P2 + lane] : 0.0f;
    for (int h = len / 2; h >= 1; h >>= 1) v = v + __shfl_down_sync(0xFFFFFFFFu, v, h);
    if (lane == 0) out[k] = v;
  }
  __syncthreads();
}

// The rotation's (sin, cos), as torch.sin / torch.cos of a CUDA tensor.
__device__ __forceinline__ void rotation_sin_cos(const float theta, float& s, float& c) {
  s = sinf(theta);
  c = cosf(theta);
}

// One block per cloud pair; `threads` threads, `G` lanes per source point.
// Dynamic shared memory: target tile (tx, ty, nx, ny, flags) [tile] | the
// per-point arrays (red [kSums][P2], source [N][2]) unless `scratch` holds
// them ([B][kSums * P2 + 2 * N]).
__global__ void icp_point_to_line_kernel(
    const float* __restrict__ source, const float* __restrict__ target,
    const unsigned char* __restrict__ source_valid,
    const unsigned char* __restrict__ target_valid, const float* __restrict__ normals,
    const unsigned char* __restrict__ normal_valid, float* scratch,
    float* __restrict__ theta_out, float* __restrict__ trans_out,
    float* __restrict__ err_out, int* __restrict__ iters_out, const int N, const int Mt,
    const int P2, const int tile, const int max_iter, const float tol, const int G) {
  extern __shared__ float smem[];
  __shared__ float sums[kSums];
  __shared__ float step[3];           // this iteration's theta, tx, ty
  __shared__ float carry[4];          // theta_total, t_total x, y, prev_err
  __shared__ int state[2];            // iterations, converged

  const size_t pair = blockIdx.x;
  const float* src0 = source + pair * 2 * static_cast<size_t>(N);
  const unsigned char* sval = source_valid + pair * static_cast<size_t>(N);
  const float* tgt = target + pair * 2 * static_cast<size_t>(Mt);
  const unsigned char* tval = target_valid + pair * static_cast<size_t>(Mt);
  const float* nrm = normals + pair * 2 * static_cast<size_t>(Mt);
  const unsigned char* nval = normal_valid + pair * static_cast<size_t>(Mt);

  float* tx_s = smem;
  float* ty_s = tx_s + tile;
  float* nx_s = ty_s + tile;
  float* ny_s = nx_s + tile;
  int* fl_s = reinterpret_cast<int*>(ny_s + tile);
  const size_t per_pair = static_cast<size_t>(kSums) * P2 + 2 * static_cast<size_t>(N);
  float* red = scratch != nullptr ? scratch + pair * per_pair
                                  : reinterpret_cast<float*>(fl_s + tile);
  float* sxy = red + static_cast<size_t>(kSums) * P2;

  const bool single = Mt <= tile;
  for (int i = threadIdx.x; i < 2 * N; i += blockDim.x) sxy[i] = src0[i];
  for (int e = threadIdx.x; e < kSums * (P2 - N); e += blockDim.x) {
    const int k = e / (P2 - N);
    red[k * P2 + N + (e - k * (P2 - N))] = 0.0f;   // the padding; the tree never writes it
  }
  if (single) stage_targets(tgt, tval, nrm, nval, 0, Mt, tx_s, ty_s, nx_s, ny_s, fl_s);
  if (threadIdx.x == 0) {
    carry[0] = carry[1] = carry[2] = 0.0f;
    carry[3] = __int_as_float(0x7f800000);   // +inf
    state[0] = state[1] = 0;
  }
  __syncthreads();

  const int g = threadIdx.x & (G - 1);
  const int per_pass = blockDim.x / G;
  const unsigned lanes = group_mask(G);
  for (int it = 0; it < max_iter; ++it) {
    for (int n0 = 0; n0 < N; n0 += per_pass) {
      const int n = n0 + static_cast<int>(threadIdx.x) / G;
      const bool active = n < N;
      float sx = 0.0f, sy = 0.0f;
      if (active) {
        sx = sxy[2 * n];
        sy = sxy[2 * n + 1];
      }
      unsigned long long best = kNoTarget;
      for (int base = 0; base < Mt; base += tile) {
        const int count = min(tile, Mt - base);
        if (!single) {
          __syncthreads();  // the previous tile is no longer read
          stage_targets(tgt, tval, nullptr, nullptr, base, count, tx_s, ty_s, nullptr,
                        nullptr, fl_s);
          __syncthreads();
        }
        if (active) best = nn_search(sx, sy, tx_s, ty_s, fl_s, count, base, g, G, best);
      }
      best = lanes_min(best, G, lanes);
      if (active && g == 0) {
        const int j = static_cast<int>(static_cast<unsigned>(best));
        const float dist = key_dist(best);
        float qx, qy, nx, ny;
        bool ok;
        if (single) {
          qx = tx_s[j];
          qy = ty_s[j];
          nx = nx_s[j];
          ny = ny_s[j];
          ok = (fl_s[j] & 2) != 0;
        } else {
          qx = tgt[2 * static_cast<size_t>(j)];
          qy = tgt[2 * static_cast<size_t>(j) + 1];
          nx = nrm[2 * static_cast<size_t>(j)];
          ny = nrm[2 * static_cast<size_t>(j) + 1];
          ok = nval[j] != 0;
        }
        const float w = (sval[n] ? 1.0f : 0.0f) * (ok ? 1.0f : 0.0f);
        const float r = (sx - qx) * nx + (sy - qy) * ny;
        const float j0 = sx * ny - sy * nx;   // J = [s x n, n_x, n_y]
        const float wj0 = w * j0;
        const float wj1 = w * nx;
        const float wj2 = w * ny;
        red[n] = wj0 * j0;
        red[P2 + n] = wj0 * nx;
        red[2 * P2 + n] = wj0 * ny;
        red[3 * P2 + n] = wj1 * nx;
        red[4 * P2 + n] = wj1 * ny;
        red[5 * P2 + n] = wj2 * ny;
        red[6 * P2 + n] = wj0 * r;
        red[7 * P2 + n] = wj1 * r;
        red[8 * P2 + n] = wj2 * r;
        red[9 * P2 + n] = dist * w;
        red[10 * P2 + n] = w;
      }
    }
    __syncthreads();
    tree_sums(red, P2, sums);

    if (threadIdx.x == 0) {
      // 3x3 symmetric solve via cofactors (proposal/icp.py:_icp_point_to_line)
      const float h00 = sums[0] + static_cast<float>(1e-9);
      const float h01 = sums[1];
      const float h02 = sums[2];
      const float h11 = sums[3] + static_cast<float>(1e-9);
      const float h12 = sums[4];
      const float h22 = sums[5] + static_cast<float>(1e-9);
      const float b0 = -sums[6];
      const float b1 = -sums[7];
      const float b2 = -sums[8];
      const float c00 = h11 * h22 - h12 * h12;
      const float c01 = h02 * h12 - h01 * h22;
      const float c02 = h01 * h12 - h02 * h11;
      float det = h00 * c00 + h01 * c01 + h02 * c02;
      det = fabsf(det) > static_cast<float>(1e-12) ? det : static_cast<float>(1e-12);
      const float c11 = h00 * h22 - h02 * h02;
      const float c12 = h01 * h02 - h00 * h12;
      const float c22 = h00 * h11 - h01 * h01;
      const float theta = (c00 * b0 + c01 * b1 + c02 * b2) / det;
      const float tx = (c01 * b0 + c11 * b1 + c12 * b2) / det;
      const float ty = (c02 * b0 + c12 * b1 + c22 * b2) / det;
      const float wsum = sums[10];
      const float err = sums[9] / (wsum < static_cast<float>(1e-12)
                                       ? static_cast<float>(1e-12) : wsum);
      float s, c;
      rotation_sin_cos(theta, s, c);
      const float ttx = carry[1];
      const float tty = carry[2];
      carry[1] = (c * ttx - s * tty) + tx;
      carry[2] = (s * ttx + c * tty) + ty;
      carry[0] = carry[0] + theta;
      state[1] = fabsf(carry[3] - err) < tol;
      carry[3] = err;
      state[0] = it + 1;
      step[0] = theta;
      step[1] = tx;
      step[2] = ty;
    }
    __syncthreads();
    float s, c;
    rotation_sin_cos(step[0], s, c);
    const float tx = step[1];
    const float ty = step[2];
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float x = sxy[2 * i];
      const float y = sxy[2 * i + 1];
      sxy[2 * i] = (c * x - s * y) + tx;
      sxy[2 * i + 1] = (s * x + c * y) + ty;
    }
    if (state[1]) break;    // block-uniform: read after the barrier above
    __syncthreads();        // the moved source is read by other threads next
  }
  if (threadIdx.x == 0) {
    theta_out[pair] = carry[0];
    trans_out[2 * pair] = carry[1];
    trans_out[2 * pair + 1] = carry[2];
    err_out[pair] = carry[3];
    iters_out[pair] = state[0];
  }
}

__global__ void icp_sin_cos_kernel(const float* __restrict__ x, float* __restrict__ s,
                                   float* __restrict__ c, const int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    rotation_sin_cos(x[i], s[i], c[i]);
  }
}

// Shared memory of a point-to-line block, or 0 for a geometry the kernel
// does not take (core/cuda_kernels.py:icp_fused_layout computes the same):
// the target tile, plus the per-point arrays unless they go to scratch.
size_t icp_fused_shared_bytes(const int N, const int Mt, const int P2, const int threads,
                              const int lanes, const bool in_scratch) {
  const bool lanes_ok = lanes > 0 && (lanes & (lanes - 1)) == 0 && lanes <= 32;
  // P2: the least power of two >= N
  if (N < 1 || Mt < 1 || P2 < N || (P2 & (P2 - 1)) != 0 || P2 / 2 >= N || !lanes_ok || threads < 32 || threads % 32 != 0 || threads > 1024) {
    return 0;
  }
  const size_t tile = Mt < TGT_TILE ? Mt : TGT_TILE;
  const size_t points = (static_cast<size_t>(kSums) * P2 + 2 * static_cast<size_t>(N)) * 4;
  if (in_scratch != (points > kPointSmemBytes)) return 0;
  const size_t smem = tile * 5 * 4 + (in_scratch ? 0 : points);
  return smem + 256 <= kSmemOptInLimit ? smem : 0;
}

}  // namespace

extern "C" {

int icp_correspondences_launch(int device, const float* source, const float* target,
                               const unsigned char* target_valid, float* dist,
                               int* idx, int B, int N, int Mt, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || N == 0) return 0;
  const int per_tile = NN_THREADS / NN_LANES;
  const int tiles = (N + per_tile - 1) / per_tile;
  const dim3 grid(B, tiles < 65535 ? tiles : 65535);
  icp_nn_kernel<<<grid, NN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      source, target, target_valid, dist, idx, N, Mt);
  return static_cast<int>(cudaGetLastError());
}

int icp_point_to_line_launch(int device, const float* source, const float* target,
                             const unsigned char* source_valid,
                             const unsigned char* target_valid, const float* normals,
                             const unsigned char* normal_valid, float* scratch,
                             float* theta, float* trans, float* mean_err, int* iters, int B,
                             int N, int Mt, int P2, int max_iter, float tol, int threads,
                             int lanes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = icp_fused_shared_bytes(N, Mt, P2, threads, lanes, scratch != nullptr);
  if (smem == 0 || B < 0 || max_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  err = cudaFuncSetAttribute(icp_point_to_line_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = Mt < TGT_TILE ? Mt : TGT_TILE;
  icp_point_to_line_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      source, target, source_valid, target_valid, normals, normal_valid, scratch, theta,
      trans, mean_err, iters, N, Mt, P2, tile, max_iter, tol, lanes);
  return static_cast<int>(cudaGetLastError());
}

int icp_sin_cos_launch(int device, const float* x, float* s, float* c, int n,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  icp_sin_cos_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, s, c, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
