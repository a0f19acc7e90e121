// Fused measurement update of the FastSLAM particle filter, for Hopper (sm_90a).
//
// Replaces fastslam_tpu/core/pallas_kernels.py:_fused_update_kernel (one tick)
// and :_fused_multi_kernel (C ticks with in-kernel propagation).  Both kernels
// run apply_measurement(), which computes what pallas_kernels.py:
// _apply_measurement computes: association (packed argmin in production,
// first match with the robot-frame quirk in parity), the 2x2 landmark EKF,
// the append of an unmatched measurement, and the log-likelihood weight.
//
// Design: one thread per particle, reaching its slots through a DeviceColumn
// view (measurement.cuh).  The landmark planes are [L, P] row-major,
// so slot l of neighbouring particles sits at neighbouring addresses and every
// row access of a warp is one coalesced 128-byte transaction.  Each thread
// owns its particle's column, so the planes are updated in place.  The
// matched slot is read by direct index.  A block keeps the tick's measurement
// table ([M, 4] distance, bearing, cos b, sin b), the valid flags and the trip
// count in shared memory, and each thread's det/validity plane (det(cov) of
// every occupied slot, -1 for empty ones) as a [L, blockDim] shared array, so
// association never recomputes it.
//
// What bounds it on an H100: at P = 100,000 and L = 64 the five production
// planes are 5 x 64 x 100,000 x 4 B = 128 MB.  The association pass re-reads
// them for every measurement, up to ~2 GB per tick at M = 16, more than the
// 50 MB L2 holds, so the kernel streams device memory.  Staging a particle
// tile's planes in shared memory, as fused_fs2.cu does, is later work.
//
// Arithmetic follows the plain PyTorch version (core/cuda_kernels.py) op for
// op; the per-measurement device code is shared with the FastSLAM 2.0
// kernels in measurement.cuh.

#include "measurement.cuh"

namespace {

// Shared memory of a block: detp [L][blockDim] | z table [M][4] | valid [M]
template <bool PARITY>
__global__ void fused_update_planes_kernel(
    const float* __restrict__ poses, const float* __restrict__ cyaw_in,
    const float* __restrict__ syaw_in, float* __restrict__ logw_io,
    float* __restrict__ mx, float* __restrict__ my, float* __restrict__ ca,
    float* cb, float* cc, float* __restrict__ cd, int* __restrict__ cnt_io,
    const float* __restrict__ z4, const int* __restrict__ zvalid,
    const int* __restrict__ mlast, const int P, const int L, const int M,
    const Params prm) {
  extern __shared__ float smem[];
  float* detp_s = smem;
  float* z_s = smem + static_cast<size_t>(L) * blockDim.x;
  int* zv_s = reinterpret_cast<int*>(z_s + 4 * M);
  __shared__ int mtrip;

  for (int i = threadIdx.x; i < 4 * M; i += blockDim.x) z_s[i] = z4[i];
  for (int i = threadIdx.x; i < M; i += blockDim.x) zv_s[i] = zvalid[i];
  if (threadIdx.x == 0) mtrip = min(mlast[0], M);
  __syncthreads();

  const size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= static_cast<size_t>(P)) return;
  const int stride = blockDim.x;
  float* detp = detp_s + threadIdx.x;

  int cnt = cnt_io[p];
  float logw = logw_io[p];
  const float px = poses[3 * p];
  const float py = poses[3 * p + 1];
  const float yaw = poses[3 * p + 2];
  const float cyaw = cyaw_in[p];
  const float syaw = syaw_in[p];
  init_detp(p, P, L, cnt, ca, cb, cc, cd, detp, stride);
  DeviceColumn col{mx, my, ca, cb, cc, cd, detp, stride, static_cast<size_t>(P), p, L};

  for (int m = 0; m < mtrip; ++m) {
    apply_measurement<PARITY, true>(col, L, px, py, yaw, cyaw, syaw, z_s[4 * m],
                                    z_s[4 * m + 1], z_s[4 * m + 2], z_s[4 * m + 3],
                                    zv_s[m] > 0, cnt, logw, prm);
  }
  logw_io[p] = logw;
  cnt_io[p] = cnt;
}

// C ticks: propagate, then the measurement loop of the tick, with the
// per-tick trajectory rows written out.  Every thread of a block takes part
// in loading each tick's table, so threads past P stay until the end.
template <bool PARITY>
__global__ void fused_update_planes_multi_kernel(
    const float* __restrict__ poses, const float* __restrict__ cyaw_in,
    const float* __restrict__ syaw_in, const float* __restrict__ logw_in,
    const float* __restrict__ noisy_rot, const float* __restrict__ noisy_trans,
    const float* __restrict__ cos_rot, const float* __restrict__ sin_rot,
    float* __restrict__ mx, float* __restrict__ my, float* __restrict__ ca,
    float* cb, float* cc, float* __restrict__ cd, int* __restrict__ cnt_io,
    const float* __restrict__ z4, const int* __restrict__ zvalid,
    const int* __restrict__ mlast, float* __restrict__ tx, float* __restrict__ ty,
    float* __restrict__ tyaw, float* __restrict__ tlogw, const int P, const int L,
    const int M, const int C, const Params prm) {
  extern __shared__ float smem[];
  float* detp_s = smem;
  float* z_s = smem + static_cast<size_t>(L) * blockDim.x;
  int* zv_s = reinterpret_cast<int*>(z_s + 4 * M);
  __shared__ int mtrip;

  const size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = p < static_cast<size_t>(P);
  const int stride = blockDim.x;
  float* detp = detp_s + threadIdx.x;

  int cnt = 0;
  float logw = 0.0f, px = 0.0f, py = 0.0f, yaw = 0.0f, cyaw = 0.0f, syaw = 0.0f;
  if (active) {
    cnt = cnt_io[p];
    logw = logw_in[p];
    px = poses[3 * p];
    py = poses[3 * p + 1];
    yaw = poses[3 * p + 2];
    cyaw = cyaw_in[p];
    syaw = syaw_in[p];
    init_detp(p, P, L, cnt, ca, cb, cc, cd, detp, stride);
  }
  DeviceColumn col{mx, my, ca, cb, cc, cd, detp, stride, static_cast<size_t>(P), p, L};

  for (int k = 0; k < C; ++k) {
    __syncthreads();  // the previous tick's table is no longer read
    const float* zk = z4 + static_cast<size_t>(k) * 4 * M;
    for (int i = threadIdx.x; i < 4 * M; i += blockDim.x) z_s[i] = zk[i];
    for (int i = threadIdx.x; i < M; i += blockDim.x) zv_s[i] = zvalid[k * M + i];
    if (threadIdx.x == 0) mtrip = min(mlast[k], M);
    __syncthreads();
    if (!active) continue;

    const size_t kp = static_cast<size_t>(k) * P + p;
    const float cnr = cos_rot[kp];
    const float snr = sin_rot[kp];
    const float ntrans = noisy_trans[kp];
    yaw = wrap_pi(yaw + noisy_rot[kp]);
    const float c2 = cyaw * cnr - syaw * snr;
    const float s2 = syaw * cnr + cyaw * snr;
    const float inv_n = 1.0f / sqrtf(c2 * c2 + s2 * s2);  // renormalize
    cyaw = c2 * inv_n;
    syaw = s2 * inv_n;
    px = px + ntrans * cyaw;  // translation along the new heading
    py = py + ntrans * syaw;

    for (int m = 0; m < mtrip; ++m) {
      apply_measurement<PARITY, true>(col, L, px, py, yaw, cyaw, syaw, z_s[4 * m],
                                      z_s[4 * m + 1], z_s[4 * m + 2], z_s[4 * m + 3],
                                      zv_s[m] > 0, cnt, logw, prm);
    }
    tx[kp] = px;
    ty[kp] = py;
    tyaw[kp] = yaw;
    tlogw[kp] = logw;
  }
  if (active) cnt_io[p] = cnt;
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
    float default_cov, float default_cov2, int threads, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P == 0) return 0;
  const Params prm{gate2, gate_thr, meas_noise, default_cov, default_cov2};
  const dim3 grid((P + threads - 1) / threads);
  const size_t smem = shared_bytes(L, M, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parity) {
    fused_update_planes_kernel<true><<<grid, threads, smem, s>>>(
        poses, cyaw, syaw, logw, mx, my, ca, cb, cc, cd, cnt, z4, zvalid, mlast,
        P, L, M, prm);
  } else {
    fused_update_planes_kernel<false><<<grid, threads, smem, s>>>(
        poses, cyaw, syaw, logw, mx, my, ca, cb, cc, cd, cnt, z4, zvalid, mlast,
        P, L, M, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

int fused_update_planes_multi_launch(
    int device, const float* poses, const float* cyaw, const float* syaw,
    const float* logw, const float* noisy_rot, const float* noisy_trans,
    const float* cos_rot, const float* sin_rot, float* mx, float* my, float* ca,
    float* cb, float* cc, float* cd, int* cnt, const float* z4, const int* zvalid,
    const int* mlast, float* tx, float* ty, float* tyaw, float* tlogw, int P, int L,
    int M, int C, int parity, float gate2, int gate_thr, float meas_noise,
    float default_cov, float default_cov2, int threads, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P == 0 || C == 0) return 0;
  const Params prm{gate2, gate_thr, meas_noise, default_cov, default_cov2};
  const dim3 grid((P + threads - 1) / threads);
  const size_t smem = shared_bytes(L, M, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parity) {
    fused_update_planes_multi_kernel<true><<<grid, threads, smem, s>>>(
        poses, cyaw, syaw, logw, noisy_rot, noisy_trans, cos_rot, sin_rot, mx, my,
        ca, cb, cc, cd, cnt, z4, zvalid, mlast, tx, ty, tyaw, tlogw, P, L, M, C, prm);
  } else {
    fused_update_planes_multi_kernel<false><<<grid, threads, smem, s>>>(
        poses, cyaw, syaw, logw, noisy_rot, noisy_trans, cos_rot, sin_rot, mx, my,
        ca, cb, cc, cd, cnt, z4, zvalid, mlast, tx, ty, tyaw, tlogw, P, L, M, C, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
