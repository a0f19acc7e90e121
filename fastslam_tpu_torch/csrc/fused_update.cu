// Fused measurement update of the FastSLAM particle filter, for Hopper (sm_90a).
//
// Replaces fastslam_tpu/core/pallas_kernels.py:_fused_update_kernel (one tick)
// and :_fused_multi_kernel (C ticks with in-kernel propagation).  Both kernels
// run apply_measurement(), which computes what pallas_kernels.py:
// _apply_measurement computes: association (packed argmin in production,
// first match with the robot-frame quirk in parity), the 2x2 landmark EKF,
// the append of an unmatched measurement, and the log-likelihood weight.
//
// Both stage a tile of particles (tile.cuh, as the fs2 kernels do): a block
// owns T particles with G lanes each, stages the tile's planes in dynamic
// shared memory, only the slots below the tile's largest count (the five
// production planes and 1/det(cov); in parity the det(cov) entry and the
// sixth, cc, plane as well), runs the measurements over that TileColumn,
// and writes back only the slots that a measurement updated or appended.
// The per-tick kernel stages once per tick, the chunked kernel once per
// chunk: its C ticks read and write shared memory only, and a slot appended
// on one tick is scanned from there on the next.  The lanes split each
// association scan: the packed argmin in production, the first hit under
// the gate in parity (each lane's first hit among slots g, g + G, ..., then
// the smallest slot by shuffle, exact because a minimum of indices does not
// depend on order).
//
// What bounds them on an H100: at P = 100,000 and L = 64 the five
// production planes are 5 x 64 x 100,000 x 4 B = 128 MB.  A kernel reads
// them once per launch (the occupied slots) and writes back the slots that
// changed; the scans then run in shared memory (M x 64 slots x 6 floats per
// particle and tick, ~2.5 GB per tick at M = 16), so shared-memory traffic
// and the scans' arithmetic, not device memory, bound them.
//
// Arithmetic follows the plain PyTorch version (core/cuda_kernels.py) op for
// op; the per-measurement device code is shared with the FastSLAM 2.0
// kernels in measurement.cuh.

#include "tile.cuh"

namespace {

// One tick for a tile of T = blockDim / G particles, G lanes each.
template <bool PARITY>
__global__ void fused_update_planes_kernel(
    const float* __restrict__ poses, const float* __restrict__ cyaw_in,
    const float* __restrict__ syaw_in, float* __restrict__ logw_io,
    float* __restrict__ mx, float* __restrict__ my, float* __restrict__ ca,
    float* cb, float* cc, float* __restrict__ cd, int* __restrict__ cnt_io,
    const float* __restrict__ z4, const int* __restrict__ zvalid,
    const int* __restrict__ mlast, const int P, const int L, const int M, const int G,
    const Params prm) {
  extern __shared__ float smem[];
  __shared__ int mtrip, rows;
  const int T = blockDim.x / G;
  const Lanes w = lanes_of(G, T >= 32 ? 5 : __ffs(T) - 1);
  const TileBlock b = carve<PARITY>(smem, L, M, T);
  const size_t p0 = static_cast<size_t>(blockIdx.x) * T;

  for (int i = threadIdx.x; i < 4 * M; i += blockDim.x) b.z[i] = z4[i];
  for (int i = threadIdx.x; i < M; i += blockDim.x) b.zv[i] = zvalid[i];
  if (threadIdx.x == 0) mtrip = min(mlast[0], M);
  stage_tile<PARITY>(b, rows, w, p0, P, L, mx, my, ca, cb, cc, cd, cnt_io);

  const size_t p = p0 + w.i;
  if (p < static_cast<size_t>(P)) {
    TileColumn<PARITY> s = column<PARITY>(b, w, L);
    int cnt = b.cnt[w.i];
    float logw = logw_io[p];
    const float px = poses[3 * p];
    const float py = poses[3 * p + 1];
    const float yaw = poses[3 * p + 2];
    const float cyaw = cyaw_in[p];
    const float syaw = syaw_in[p];
    for (int m = 0; m < mtrip; ++m) {
      apply_measurement<PARITY, true>(s, L, px, py, yaw, cyaw, syaw, b.z[4 * m],
                                      b.z[4 * m + 1], b.z[4 * m + 2], b.z[4 * m + 3],
                                      b.zv[m] > 0, cnt, logw, prm);
    }
    if (w.g == 0) {
      logw_io[p] = logw;
      cnt_io[p] = cnt;
      atomicMax(&rows, cnt);
    }
  }
  __syncthreads();
  write_back<PARITY>(b, rows, w, p0, P, L, mx, my, ca, cb, cc, cd);
}

// C ticks on one staged tile: stage once, then per tick propagate and run
// the tick's measurements against shared memory only, with the per-tick
// trajectory rows written out; write back once at the end.  Every lane of a
// particle propagates with the same values; lane 0 writes.  Every thread of
// a block takes part in loading each tick's table, so threads past P stay
// until the end.
template <bool PARITY>
__global__ void fused_update_planes_multi_kernel(
    const float* __restrict__ poses, const float* __restrict__ cyaw_in,
    const float* __restrict__ syaw_in, const float* __restrict__ logw_in,
    const float* __restrict__ noisy_rot, const float* __restrict__ noisy_trans,
    float* __restrict__ mx, float* __restrict__ my, float* __restrict__ ca,
    float* cb, float* cc, float* __restrict__ cd, int* __restrict__ cnt_io,
    const float* __restrict__ z4, const int* __restrict__ zvalid,
    const int* __restrict__ mlast, float* __restrict__ tx, float* __restrict__ ty,
    float* __restrict__ tyaw, float* __restrict__ tlogw, const int P, const int L,
    const int M, const int C, const int G, const Params prm) {
  extern __shared__ float smem[];
  __shared__ int mtrip, rows;
  const int T = blockDim.x / G;
  const Lanes w = lanes_of(G, T >= 32 ? 5 : __ffs(T) - 1);
  const TileBlock b = carve<PARITY>(smem, L, M, T);
  const size_t p0 = static_cast<size_t>(blockIdx.x) * T;
  stage_tile<PARITY>(b, rows, w, p0, P, L, mx, my, ca, cb, cc, cd, cnt_io);

  const size_t p = p0 + w.i;
  const bool active = p < static_cast<size_t>(P);
  TileColumn<PARITY> s = column<PARITY>(b, w, L);
  int cnt = 0;
  float logw = 0.0f, px = 0.0f, py = 0.0f, yaw = 0.0f, cyaw = 0.0f, syaw = 0.0f;
  if (active) {
    cnt = b.cnt[w.i];
    logw = logw_in[p];
    px = poses[3 * p];
    py = poses[3 * p + 1];
    yaw = poses[3 * p + 2];
    cyaw = cyaw_in[p];
    syaw = syaw_in[p];
  }

  for (int k = 0; k < C; ++k) {
    __syncthreads();  // the previous tick's table is no longer read
    const float* zk = z4 + static_cast<size_t>(k) * 4 * M;
    for (int i = threadIdx.x; i < 4 * M; i += blockDim.x) b.z[i] = zk[i];
    for (int i = threadIdx.x; i < M; i += blockDim.x) b.zv[i] = zvalid[k * M + i];
    if (threadIdx.x == 0) mtrip = min(mlast[k], M);
    __syncthreads();
    if (!active) continue;

    // cosf/sinf equal torch.cos/torch.sin of a CUDA tensor bit for bit
    // under -fmad=false, which the plain version takes
    const size_t kp = static_cast<size_t>(k) * P + p;
    const float nrot = noisy_rot[kp];
    const float cnr = cosf(nrot);
    const float snr = sinf(nrot);
    const float ntrans = noisy_trans[kp];
    yaw = wrap_pi(yaw + nrot);
    const float c2 = cyaw * cnr - syaw * snr;
    const float s2 = syaw * cnr + cyaw * snr;
    const float inv_n = 1.0f / sqrtf(c2 * c2 + s2 * s2);  // renormalize
    cyaw = c2 * inv_n;
    syaw = s2 * inv_n;
    px = px + ntrans * cyaw;  // translation along the new heading
    py = py + ntrans * syaw;

    for (int m = 0; m < mtrip; ++m) {
      apply_measurement<PARITY, true>(s, L, px, py, yaw, cyaw, syaw, b.z[4 * m],
                                      b.z[4 * m + 1], b.z[4 * m + 2], b.z[4 * m + 3],
                                      b.zv[m] > 0, cnt, logw, prm);
    }
    if (w.g == 0) {
      tx[kp] = px;
      ty[kp] = py;
      tyaw[kp] = yaw;
      tlogw[kp] = logw;
    }
  }
  // rows grows to cover the slots appended in the chunk
  if (active && w.g == 0) {
    cnt_io[p] = cnt;
    atomicMax(&rows, cnt);
  }
  __syncthreads();
  write_back<PARITY>(b, rows, w, p0, P, L, mx, my, ca, cb, cc, cd);
}

// A motion block's dynamic shared memory for a tile of `tile` particles
// with `lanes` lanes each, or 0 if the kernel does not take that geometry
// (core/cuda_kernels.py:motion_launch_geometry checks the same): a tile of
// a power of two below 32 or a multiple of 32, lanes a power of two up to
// min(tile, 32), whole warps, and the staged planes within the opt-in limit.
size_t checked_motion_shared_bytes(const int L, const int M, const int tile,
                                   const int lanes, const bool parity) {
  const size_t smem = tile_shared_bytes(L, M, tile, parity ? kParityPlanes : kPlanes);
  const bool pow2 = tile > 0 && (tile & (tile - 1)) == 0;
  const bool tile_ok = tile % 32 == 0 ? tile > 0 : (pow2 && tile < 32);
  const bool lanes_ok = lanes > 0 && (lanes & (lanes - 1)) == 0 && lanes <= 32
                        && lanes <= tile;
  if (L < 1 || M < 0 || !tile_ok || !lanes_ok || (tile * lanes) % 32 != 0
      || tile * lanes > 1024 || smem + kStaticSmemBytes > kSmemOptInLimit) {
    return 0;
  }
  return smem;
}

}  // namespace

extern "C" {

const char* fastslam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fused_update_planes_launch(
    int device, const float* poses, const float* cyaw, const float* syaw,
    float* logw, float* mx, float* my, float* ca, float* cb, float* cc, float* cd,
    int* cnt, const float* z4, const int* zvalid, const int* mlast, int P, int L,
    int M, int parity, float gate2, int gate_thr, float meas_noise,
    float default_cov, float default_cov2, int tile, int lanes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = checked_motion_shared_bytes(L, M, tile, lanes, parity != 0);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  const Params prm{gate2, gate_thr, meas_noise, default_cov, default_cov2};
  const dim3 grid((P + tile - 1) / tile);
  auto kernel = parity ? fused_update_planes_kernel<true> : fused_update_planes_kernel<false>;
  // above 48 KB a block's dynamic shared memory needs the opt-in, per instance
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, tile * lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      poses, cyaw, syaw, logw, mx, my, ca, cb, cc, cd, cnt, z4, zvalid, mlast, P, L, M,
      lanes, prm);
  return static_cast<int>(cudaGetLastError());
}

int fused_update_planes_multi_launch(
    int device, const float* poses, const float* cyaw, const float* syaw,
    const float* logw, const float* noisy_rot, const float* noisy_trans, float* mx,
    float* my, float* ca, float* cb, float* cc, float* cd, int* cnt, const float* z4,
    const int* zvalid, const int* mlast, float* tx, float* ty, float* tyaw, float* tlogw,
    int P, int L, int M, int C, int parity, float gate2, int gate_thr, float meas_noise,
    float default_cov, float default_cov2, int tile, int lanes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = checked_motion_shared_bytes(L, M, tile, lanes, parity != 0);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || C == 0) return 0;
  const Params prm{gate2, gate_thr, meas_noise, default_cov, default_cov2};
  const dim3 grid((P + tile - 1) / tile);
  auto kernel = parity ? fused_update_planes_multi_kernel<true>
                       : fused_update_planes_multi_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, tile * lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      poses, cyaw, syaw, logw, noisy_rot, noisy_trans, mx, my, ca, cb, cc, cd, cnt, z4,
      zvalid, mlast, tx, ty, tyaw, tlogw, P, L, M, C, lanes, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
