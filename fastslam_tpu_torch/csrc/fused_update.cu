// Fused measurement update of the FastSLAM particle filter, for Hopper (sm_90a).
//
// Replaces fastslam_tpu/core/pallas_kernels.py:_fused_update_kernel (one tick)
// and :_fused_multi_kernel (C ticks with in-kernel propagation).  Both kernels
// run apply_measurement(), which computes what pallas_kernels.py:
// _apply_measurement computes: association (packed argmin in production,
// first match with the robot-frame quirk in parity), the 2x2 landmark EKF,
// the append of an unmatched measurement, and the log-likelihood weight.
//
// Design: one thread per particle.  The landmark planes are [L, P] row-major,
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
// tile's planes in shared memory is later work.
//
// Arithmetic follows the plain PyTorch version (core/cuda_kernels.py) op for
// op.  Build with -fmad=false so no multiply-add is contracted; divisions and
// square roots are IEEE (no fast-math), and constants are double literals
// rounded to float, as Python scalars are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = static_cast<float>(kPiD);
constexpr float kTwoPi = static_cast<float>(2.0 * kPiD);
constexpr float kHalfPi = static_cast<float>(kPiD / 2.0);
constexpr float kQuarterPi = static_cast<float>(kPiD / 4.0);
constexpr float kLogTwoPi = static_cast<float>(1.8378770664093453);  // log(2 pi)
constexpr int kInvalidKey = 0x7F8000FF;  // +inf bits with all slot bits set

struct Params {
  float gate2;         // gate^2 (parity test: d2 < gate^2 * det)
  int gate_thr;        // packed-key threshold: ((bits(gate^2) - 1) & ~0xFF) | 0xFF
  float meas_noise;
  float default_cov;
  float default_cov2;  // default_cov^2 rounded once from double
};

// max(x, c) that keeps a NaN x, as torch.clamp_min does
__device__ __forceinline__ float clamp_min(float x, float c) { return x < c ? c : x; }

__device__ __forceinline__ float atan_poly(float x) {
  const float t3p8 = static_cast<float>(2.414213562373095);   // tan(3 pi / 8)
  const float tp8 = static_cast<float>(0.4142135623730950);   // tan(pi / 8)
  const bool big = x > t3p8;
  const bool mid = (x > tp8) && !big;
  const float xr = big ? (-1.0f / (x == 0.0f ? 1.0f : x))
                       : (mid ? (x - 1.0f) / (x + 1.0f) : x);
  const float base = big ? kHalfPi : (mid ? kQuarterPi : 0.0f);
  const float z = xr * xr;
  const float p = ((((static_cast<float>(8.05374449538e-2) * z
                      - static_cast<float>(1.38776856032e-1)) * z
                     + static_cast<float>(1.99777106478e-1)) * z
                    - static_cast<float>(3.33329491539e-1)) * z) * xr + xr;
  return base + p;
}

__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float safe_ax = ax == 0.0f ? 1.0f : ax;
  float a = atan_poly(ay / safe_ax);
  if (ax == 0.0f) a = kHalfPi;
  if (x < 0.0f) a = kPi - a;
  if (y < 0.0f) a = -a;
  if (y == 0.0f && x < 0.0f) a = kPi;
  if (y == 0.0f && x >= 0.0f) a = 0.0f;
  return a;
}

// wrap to (-pi, pi] for |x| < 3 pi by conditional subtraction
__device__ __forceinline__ float wrap_pi(float x) {
  for (int i = 0; i < 2; ++i) {
    if (x > kPi) x = x - kTwoPi;
    if (x < -kPi) x = x + kTwoPi;
  }
  return x;
}

// One measurement for one particle.  cc aliases cb in production mode, where
// the covariance stays symmetric and no cc plane exists.  detp points at this
// thread's det/validity entries, `stride` floats apart.
template <bool PARITY>
__device__ __forceinline__ void apply_measurement(
    const size_t p, const size_t P, const int L,
    float* __restrict__ mx, float* __restrict__ my, float* __restrict__ ca,
    float* cb, float* cc, float* __restrict__ cd,
    float* __restrict__ detp, const int stride,
    const float px, const float py, const float yaw, const float cyaw, const float syaw,
    const float dist_z, const float bearing_z, const float cos_b, const float sin_b,
    const bool z_ok, int& cnt, float& logw, const Params& prm) {
  // world-frame observation by angle addition
  const float wx = px + dist_z * (cyaw * cos_b - syaw * sin_b);
  const float wy = py + dist_z * (syaw * cos_b + cyaw * sin_b);

  int idx;
  bool has_match;
  if (PARITY) {
    // first hit under the gate, against the robot-frame observation
    const float qx = dist_z * cos_b;
    const float qy = dist_z * sin_b;
    idx = L;
    for (int l = 0; l < L; ++l) {
      const float dtp = detp[l * stride];
      if (!(dtp > 0.0f)) continue;
      const size_t o = static_cast<size_t>(l) * P + p;
      const float dx = mx[o] - qx;
      const float dy = my[o] - qy;
      const float d2f = dx * (cd[o] * dx - cb[o] * dy) + dy * (-cc[o] * dx + ca[o] * dy);
      if (d2f < prm.gate2 * dtp) {
        idx = l;
        break;
      }
    }
    has_match = idx < L;
  } else {
    // packed argmin over (distance bits with 8 LSBs dropped) | slot
    int kmin = kInvalidKey;
    for (int l = 0; l < L; ++l) {
      const float dtp = detp[l * stride];
      if (!(dtp > 0.0f)) continue;
      const size_t o = static_cast<size_t>(l) * P + p;
      const float dx = mx[o] - wx;
      const float dy = my[o] - wy;
      const float d2f = dx * (cd[o] * dx - cb[o] * dy) + dy * (-cc[o] * dx + ca[o] * dy);
      const float dist2 = clamp_min(d2f * (1.0f / dtp), 0.0f);
      const int key = (__float_as_int(dist2) & ~0xFF) | l;
      kmin = min(kmin, key);
    }
    has_match = kmin <= prm.gate_thr;
    idx = kmin & 0xFF;
  }

  const bool do_update = has_match && z_ok;
  const bool do_append = !has_match && cnt < L && z_ok;
  if (do_update) {
    const size_t o = static_cast<size_t>(idx) * P + p;
    const float mu_x = mx[o];
    const float mu_y = my[o];
    const float a = ca[o];
    const float b = cb[o];
    const float c = PARITY ? cc[o] : b;
    const float d = cd[o];

    const float dx = mu_x - px;
    const float dy = mu_y - py;
    const float q = clamp_min(dx * dx + dy * dy, static_cast<float>(1e-12));
    const float rinv = 1.0f / sqrtf(q);
    const float qinv = rinv * rinv;
    const float r = q * rinv;
    const float nu_r = dist_z - r;
    const float nu_b = wrap_pi(bearing_z + yaw - atan2_poly(dy, dx));

    const float h00 = dx * rinv;
    const float h01 = dy * rinv;
    const float h10 = -dy * qinv;
    const float h11 = dx * qinv;

    const float u0 = h00 * a + h01 * c;
    const float u1 = h00 * b + h01 * d;
    const float v0 = h10 * a + h11 * c;
    const float v1 = h10 * b + h11 * d;
    const float s00 = u0 * h00 + u1 * h01 + prm.meas_noise;
    const float s01 = u0 * h10 + u1 * h11;
    const float s10 = v0 * h00 + v1 * h01;
    const float s11 = v0 * h10 + v1 * h11 + prm.meas_noise;

    const float s_det = s00 * s11 - s01 * s10;
    const float t = s_det + static_cast<float>(1e-30);
    const float sgn = t > 0.0f ? 1.0f : (t < 0.0f ? -1.0f : 0.0f);  // sign(0) == 0
    const float s_det_safe = clamp_min(fabsf(s_det), static_cast<float>(1e-18)) * sgn;
    const float sdi = 1.0f / s_det_safe;
    const float i00 = s11 * sdi;
    const float i01 = -s01 * sdi;
    const float i10 = -s10 * sdi;
    const float i11 = s00 * sdi;

    const float m0 = a * h00 + b * h01;
    const float m1 = c * h00 + d * h01;
    const float n0 = a * h10 + b * h11;
    const float n1 = c * h10 + d * h11;
    const float k00 = m0 * i00 + n0 * i10;
    const float k01 = m0 * i01 + n0 * i11;
    const float k10 = m1 * i00 + n1 * i10;
    const float k11 = m1 * i01 + n1 * i11;

    const float g00 = 1.0f - (k00 * h00 + k01 * h10);
    const float g01 = -(k00 * h01 + k01 * h11);
    const float g10 = -(k10 * h00 + k11 * h10);
    const float g11 = 1.0f - (k10 * h01 + k11 * h11);
    const float new_a = g00 * a + g01 * c;
    float new_b = g00 * b + g01 * d;
    float new_c = g10 * a + g11 * c;
    const float new_d = g10 * b + g11 * d;
    if (!PARITY) {
      const float off = 0.5f * (new_b + new_c);
      new_b = off;
      new_c = off;
    }

    const float maha = i00 * nu_r * nu_r + (i01 + i10) * nu_r * nu_b + i11 * nu_b * nu_b;
    const float log_lik =
        -0.5f * (maha + logf(clamp_min(s_det, static_cast<float>(1e-30)))) - kLogTwoPi;

    mx[o] = mu_x + k00 * nu_r + k01 * nu_b;
    my[o] = mu_y + k10 * nu_r + k11 * nu_b;
    ca[o] = new_a;
    cb[o] = new_b;
    if (PARITY) cc[o] = new_c;
    cd[o] = new_d;
    detp[idx * stride] = new_a * new_d - new_b * new_c;
    logw = logw + log_lik;
  } else if (do_append) {
    const size_t o = static_cast<size_t>(cnt) * P + p;
    mx[o] = wx;
    my[o] = wy;
    ca[o] = prm.default_cov;
    cb[o] = 0.0f;
    if (PARITY) cc[o] = 0.0f;
    cd[o] = prm.default_cov;
    detp[cnt * stride] = prm.default_cov2;
    cnt += 1;
  }
}

// det/validity plane of one particle: det(cov) of occupied slots, -1 beyond
__device__ __forceinline__ void init_detp(
    const size_t p, const size_t P, const int L, const int cnt,
    const float* __restrict__ ca, const float* cb, const float* cc,
    const float* __restrict__ cd, float* __restrict__ detp, const int stride) {
  for (int l = 0; l < L; ++l) {
    const size_t o = static_cast<size_t>(l) * P + p;
    detp[l * stride] = l < cnt ? ca[o] * cd[o] - cb[o] * cc[o] : -1.0f;
  }
}

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

  for (int m = 0; m < mtrip; ++m) {
    apply_measurement<PARITY>(p, P, L, mx, my, ca, cb, cc, cd, detp, stride,
                              px, py, yaw, cyaw, syaw, z_s[4 * m], z_s[4 * m + 1],
                              z_s[4 * m + 2], z_s[4 * m + 3], zv_s[m] > 0, cnt,
                              logw, prm);
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
      apply_measurement<PARITY>(p, P, L, mx, my, ca, cb, cc, cd, detp, stride,
                                px, py, yaw, cyaw, syaw, z_s[4 * m], z_s[4 * m + 1],
                                z_s[4 * m + 2], z_s[4 * m + 3], zv_s[m] > 0, cnt,
                                logw, prm);
    }
    tx[kp] = px;
    ty[kp] = py;
    tyaw[kp] = yaw;
    tlogw[kp] = logw;
  }
  if (active) cnt_io[p] = cnt;
}

size_t shared_bytes(int L, int M, int threads) {
  return (static_cast<size_t>(L) * threads + 5 * static_cast<size_t>(M)) * sizeof(float);
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
