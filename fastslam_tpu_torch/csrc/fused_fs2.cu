// Fused FastSLAM 2.0 tick of the particle filter, for Hopper (sm_90a).
//
// Replaces fastslam_tpu/core/pallas_kernels.py:fused_fs2_planes (its body
// _fused_fs2_kernel, one tick) and :fused_fs2_planes_multi
// (_fused_fs2_multi_kernel, C ticks with in-kernel mean-motion prediction).
// Per tick and particle:
//
//   1. accumulate the pose information (Lambda, eta) over the tick's
//      measurements at the PREDICTED pose: production packed-argmin
//      association, the Gauss-Newton terms behind the 9.21 chi^2 gate,
//      scaled by the mode dial, and (EVIDENCE) the evidence log-weight, as
//      pallas_kernels.py:_accumulate_proposal;
//   2. Sigma = Lambda^-1 in closed form, mu = pred + Sigma eta, and the
//      sample mu + chol(Sigma + 1e-9 I) n, as :_solve_sample_pose; the
//      sampled yaw's cos/sin come from the polynomial sin_cos_poly;
//   3. the landmark EKF over the same measurements at the SAMPLED pose
//      (apply_measurement of measurement.cuh, production, symmetric
//      covariance: no cc plane).  It adds the measurement likelihood to the
//      weight unless EVIDENCE, where the proposal's evidence carries it.
//
// Design.  A block owns a tile of T particles, with G lanes (threads) per
// particle.  It stages the tile's five production planes (mx, my, ca, cb, cd)
// and 1/det(cov) of every occupied slot in dynamic shared memory, laid out
// [plane][slot][T], only the slots below the tile's largest count, with
// plain coalesced 4-byte loads (any P; rows of the [L, P] planes need not be
// 16-byte aligned).  Both passes of every measurement then read and
// write shared memory only, and an append writes its new slot there.  At the
// end the block writes back, coalesced, only the slots that a measurement
// updated or appended (a bit per slot and particle in shared memory), and
// the rows.  The chunked kernel keeps the tile resident across its C ticks:
// the planes go back once per chunk, the trajectory rows every tick.  The
// TPU kernels held the [L, tile] planes in VMEM for the tick and the chunk
// the same way.  The tile machinery (TileColumn, stage_tile, write_back) is
// shared with the per-tick motion kernel in tile.cuh.
//
// The G lanes of a particle split its association scan: lane g takes slots
// g, g + G, ..., and the lanes take the smallest packed key with
// __shfl_xor_sync.  A key is the distance with the slot in its low 8 bits,
// and an integer minimum does not depend on order, so the split is exact.
// The rest (the proposal terms, the 3x3 solve and sample, the EKF update)
// runs identically on all G lanes; lane 0 stores.  Slot l of particle i sits
// at column i ^ ((l mod G) * 32 / G) of its row, so the G slots that the
// lanes of a warp's particles read together fall in distinct banks.  The
// stored 1/det (-1 for an unusable slot) takes the divide out of the scan.
//
// What bounds it on an H100, at P = 100,000, L = 64, M = 16 and a full map:
// device memory carries the staging (the 128 MB of planes read once per
// tick, once per chunk in the chunked kernel; ~0.05 ms at the measured copy
// rate) and the write-back of the updated slots.  The rest is the
// association in shared memory: per particle and tick 2 x 16 scans of 64
// slots, 6 floats and ~25 instructions per slot, ~4.9 GB in all.  Measured
// (chip_smoke.py phase 9, device time): 0.43 ms per tick one tick at a time,
// 0.36 ms per tick in a chunk of 16; the difference is about the staging.
// So the scans' shared-memory loads and arithmetic bound it, at ~14 TB/s,
// not device memory.
//
// Launch geometry (core/cuda_kernels.py:fs2_launch_geometry): T = 32
// particles and G = 4 lanes, 128 threads and 49,856 bytes per block, 4
// blocks (16 warps) per SM, timed fastest of (128, 1) ... (32, 8) at that
// geometry (PERF.md §6).  One lane per particle leaves the scan's
// shared-memory latency exposed (64 x 1 costs 1.5x); 8 lanes multiply the
// per-particle work every lane repeats.  At L = 256 a tile of 32 still fits
// (196,608 bytes of planes).
//
// Arithmetic follows the plain PyTorch versions (core/cuda_kernels.py) op
// for op; build with -fmad=false.

#include "tile.cuh"

namespace {

// the pose information (upper triangle of Lambda), eta and the evidence
// log-weight of one particle
struct Acc {
  float l00, l01, l02, l11, l12, l22;
  float e0, e1, e2;
  float logw_add;
};

// One measurement of the proposal accumulation at the predicted pose.
template <bool EVIDENCE>
__device__ __forceinline__ void accumulate_proposal(
    const TileColumn<false>& s, const int cnt,
    const float px, const float py, const float yaw, const float cyaw, const float syaw,
    const float p00, const float p01, const float p11, const float s_r2,
    const float scale, const float dist_z, const float bearing_z, const float cos_b,
    const float sin_b, const bool z_ok, Acc& acc, const Params& prm) {
  const float wx = px + dist_z * (cyaw * cos_b - syaw * sin_b);
  const float wy = py + dist_z * (syaw * cos_b + cyaw * sin_b);
  const int kmin = s.argmin(wx, wy, cnt);
  const bool has_match = kmin <= prm.gate_thr;
  bool use = has_match && z_ok;

  // the matched landmark, zeros without a match (gated below)
  float mu_x = 0.0f, mu_y = 0.0f, a = 0.0f, b = 0.0f, d = 0.0f;
  if (has_match) {
    float c_unused;
    s.load<false>(kmin & 0xFF, mu_x, mu_y, a, b, c_unused, d);
  }
  const float c = b;

  const float dx = mu_x - px;
  const float dy = mu_y - py;
  const float q = clamp_min(dx * dx + dy * dy, static_cast<float>(1e-12));
  const float rinv = 1.0f / sqrtf(q);
  const float qinv = rinv * rinv;
  const float r = q * rinv;
  const float nu_r = dist_z - r;
  const float nu_b = wrap_pi(bearing_z + yaw - atan2_poly(dy, dx));

  // landmark-side innovation covariance S~ = Hm Sig Hm' + R
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
  const float s11 = v0 * h10 + v1 * h11 + prm.meas_noise;
  const float s_det = clamp_min(s00 * s11 - s01 * s01, static_cast<float>(1e-18));
  const float si = 1.0f / s_det;
  const float i00 = s11 * si;
  const float i01 = -s01 * si;
  const float i11 = s00 * si;

  // chi^2 innovation gate (99 %, 2 dof)
  const float maha_gate =
      i00 * nu_r * nu_r + 2.0f * i01 * nu_r * nu_b + i11 * nu_b * nu_b;
  use = use && (maha_gate < static_cast<float>(9.21));

  // pose Jacobian Hx = [[-dx/r, -dy/r, 0], [dy/q, -dx/q, -1]]
  const float g00 = -h00, g01 = -h01;
  const float g10 = -h10, g11 = -h11;
  const float t00 = i00 * g00 + i01 * g10;
  const float t01 = i00 * g01 + i01 * g11;
  const float t02 = -i01;
  const float t10 = i01 * g00 + i11 * g10;
  const float t11 = i01 * g01 + i11 * g11;
  const float t12 = -i11;
  const float d00 = g00 * t00 + g10 * t10;
  const float d01 = g00 * t01 + g10 * t11;
  const float d02 = g00 * t02 + g10 * t12;
  const float d11 = g01 * t01 + g11 * t11;
  const float d12 = g01 * t02 + g11 * t12;
  const float d22 = -t12;
  const float e0 = t00 * nu_r + t10 * nu_b;
  const float e1 = t01 * nu_r + t11 * nu_b;
  const float e2 = t02 * nu_r + t12 * nu_b;

  // the mode dial scales Lambda and eta, never the evidence weight
  const float luse = (use ? 1.0f : 0.0f) * scale;
  acc.l00 = acc.l00 + luse * d00;
  acc.l01 = acc.l01 + luse * d01;
  acc.l02 = acc.l02 + luse * d02;
  acc.l11 = acc.l11 + luse * d11;
  acc.l12 = acc.l12 + luse * d12;
  acc.l22 = acc.l22 + luse * d22;
  acc.e0 = acc.e0 + luse * e0;
  acc.e1 = acc.e1 + luse * e1;
  acc.e2 = acc.e2 + luse * e2;

  if (EVIDENCE && use) {
    // evidence weight N(nu; 0, S~ + Hx P0 Hx'), the motion prior
    // P0 = [[p00, p01, 0], [p01, p11, 0], [0, 0, s_r2]] through Hx
    const float q00 = g00 * (p00 * g00 + p01 * g01) + g01 * (p01 * g00 + p11 * g01);
    const float q01 = g00 * (p00 * g10 + p01 * g11) + g01 * (p01 * g10 + p11 * g11);
    const float q11 =
        g10 * (p00 * g10 + p01 * g11) + g11 * (p01 * g10 + p11 * g11) + s_r2;
    const float z00 = s00 + q00;
    const float z01 = s01 + q01;
    const float z11 = s11 + q11;
    const float z_det = clamp_min(z00 * z11 - z01 * z01, static_cast<float>(1e-30));
    const float zi = 1.0f / z_det;
    const float maha =
        (z11 * nu_r * nu_r - 2.0f * z01 * nu_r * nu_b + z00 * nu_b * nu_b) * zi;
    const float log_ev = -0.5f * (maha + logf(z_det)) - kLogTwoPi;
    acc.logw_add = acc.logw_add + log_ev;
  }
}

// Sigma = Lambda^-1 (closed-form 3x3), mu = pred + Sigma eta, pose =
// mu + chol(Sigma + 1e-9 I) n, the yaw wrapped to (-pi, pi]
__device__ __forceinline__ void solve_sample_pose(
    const Acc& acc, const float px, const float py, const float yaw,
    const float n0, const float n1, const float n2,
    float& new_x, float& new_y, float& new_yaw) {
  const float l00 = acc.l00, l01 = acc.l01, l02 = acc.l02;
  const float l11 = acc.l11, l12 = acc.l12, l22 = acc.l22;
  const float co00 = l11 * l22 - l12 * l12;
  const float co01 = l02 * l12 - l01 * l22;
  const float co02 = l01 * l12 - l02 * l11;
  float det = l00 * co00 + l01 * co01 + l02 * co02;
  const float tiny = static_cast<float>(1e-18);
  det = fabsf(det) > tiny ? det : tiny;
  const float inv_det = 1.0f / det;
  const float s00 = co00 * inv_det;
  const float s01 = co01 * inv_det;
  const float s02 = co02 * inv_det;
  const float s11 = (l00 * l22 - l02 * l02) * inv_det;
  const float s12 = (l01 * l02 - l00 * l12) * inv_det;
  const float s22 = (l00 * l11 - l01 * l01) * inv_det;

  const float mu0 = px + s00 * acc.e0 + s01 * acc.e1 + s02 * acc.e2;
  const float mu1 = py + s01 * acc.e0 + s11 * acc.e1 + s12 * acc.e2;
  const float mu2 = yaw + s02 * acc.e0 + s12 * acc.e1 + s22 * acc.e2;

  const float jitter = static_cast<float>(1e-9);
  const float a = s00 + jitter;
  const float d = s11 + jitter;
  const float f = s22 + jitter;
  const float c00 = sqrtf(clamp_min(a, tiny));
  const float c10 = s01 / c00;
  const float c20 = s02 / c00;
  const float c11 = sqrtf(clamp_min(d - c10 * c10, tiny));
  const float c21 = (s12 - c20 * c10) / c11;
  const float c22 = sqrtf(clamp_min(f - c20 * c20 - c21 * c21, tiny));

  new_x = mu0 + c00 * n0;
  new_y = mu1 + c10 * n0 + c11 * n1;
  new_yaw = wrap_pi(mu2 + c20 * n0 + c21 * n1 + c22 * n2);
}

// One fs2 tick of one particle.  On entry (px, py, yaw, cyaw, syaw) is the
// predicted pose, on exit the sampled one.  prior_s: (s_t2, s_r2, fxy, dial).
template <bool EVIDENCE>
__device__ __forceinline__ void fs2_tick(
    TileColumn<false>& s, const int L, const float* z_s, const int* zv_s, const int mtrip,
    const float* prior_s, const float n0, const float n1, const float n2,
    float& px, float& py, float& yaw, float& cyaw, float& syaw,
    int& cnt, float& logw, const Params& prm) {
  const float s_t2 = prior_s[0];
  const float s_r2 = prior_s[1];
  const float fxy = prior_s[2];
  const float dial = prior_s[3];

  // motion-prior covariance rows and the information-form start of Lambda
  const float p00 = cyaw * cyaw * s_t2 + syaw * syaw * fxy;
  const float p01 = cyaw * syaw * (s_t2 - fxy);
  const float p11 = syaw * syaw * s_t2 + cyaw * cyaw * fxy;
  const float det_p = p00 * p11 - p01 * p01;
  const float i_p = 1.0f / clamp_min(det_p, static_cast<float>(1e-18));
  Acc acc{p11 * i_p, -p01 * i_p, 0.0f, p00 * i_p, 0.0f, 1.0f / s_r2,
          0.0f, 0.0f, 0.0f, 0.0f};

  for (int m = 0; m < mtrip; ++m) {
    accumulate_proposal<EVIDENCE>(s, cnt, px, py, yaw, cyaw, syaw, p00, p01, p11, s_r2,
                                  dial, z_s[4 * m], z_s[4 * m + 1], z_s[4 * m + 2],
                                  z_s[4 * m + 3], zv_s[m] > 0, acc, prm);
  }
  if (EVIDENCE) logw = logw + acc.logw_add;

  float x, y, th;
  solve_sample_pose(acc, px, py, yaw, n0, n1, n2, x, y, th);
  float sn, cs;
  sin_cos_poly(th, sn, cs);
  px = x;
  py = y;
  yaw = th;
  cyaw = cs;
  syaw = sn;

  for (int m = 0; m < mtrip; ++m) {
    apply_measurement<false, !EVIDENCE>(s, L, px, py, yaw, cyaw, syaw, z_s[4 * m],
                                        z_s[4 * m + 1], z_s[4 * m + 2], z_s[4 * m + 3],
                                        zv_s[m] > 0, cnt, logw, prm);
  }
}

// One tick from the caller's predicted poses; noise is [P, 3].  A block of
// T * G threads owns T particles.
template <bool EVIDENCE>
__global__ void fused_fs2_planes_kernel(
    const float* __restrict__ pred, const float* __restrict__ cyaw_in,
    const float* __restrict__ syaw_in, float* __restrict__ logw_io,
    const float* __restrict__ noise, float* __restrict__ poses_out,
    float* __restrict__ mx, float* __restrict__ my, float* __restrict__ ca,
    float* __restrict__ cb, float* __restrict__ cd, int* __restrict__ cnt_io,
    const float* __restrict__ z4, const int* __restrict__ zvalid,
    const int* __restrict__ mlast, const float* __restrict__ prior,
    const int P, const int L, const int M, const int G, const Params prm) {
  extern __shared__ float smem[];
  __shared__ int mtrip, rows;
  __shared__ float prior_s[4];
  const Lanes w = lanes_of(G);
  const TileBlock b = carve(smem, L, M, w.T);
  const size_t p0 = static_cast<size_t>(blockIdx.x) * w.T;

  for (int i = threadIdx.x; i < 4 * M; i += blockDim.x) b.z[i] = z4[i];
  for (int i = threadIdx.x; i < M; i += blockDim.x) b.zv[i] = zvalid[i];
  if (threadIdx.x < 4) prior_s[threadIdx.x] = prior[threadIdx.x];
  if (threadIdx.x == 0) mtrip = min(mlast[0], M);
  stage_tile(b, rows, w, p0, P, L, mx, my, ca, cb, nullptr, cd, cnt_io);

  const size_t p = p0 + w.i;
  if (p < static_cast<size_t>(P)) {
    TileColumn<false> s = column(b, w, L);
    int cnt = b.cnt[w.i];
    float logw = logw_io[p];
    float px = pred[3 * p];
    float py = pred[3 * p + 1];
    float yaw = pred[3 * p + 2];
    float cyaw = cyaw_in[p];
    float syaw = syaw_in[p];
    fs2_tick<EVIDENCE>(s, L, b.z, b.zv, mtrip, prior_s, noise[3 * p], noise[3 * p + 1],
                       noise[3 * p + 2], px, py, yaw, cyaw, syaw, cnt, logw, prm);
    if (w.g == 0) {
      poses_out[3 * p] = px;
      poses_out[3 * p + 1] = py;
      poses_out[3 * p + 2] = yaw;
      logw_io[p] = logw;
      cnt_io[p] = cnt;
      atomicMax(&rows, cnt);
    }
  }
  __syncthreads();
  write_back(b, rows, w, p0, P, L, mx, my, ca, cb, nullptr, cd);
}

// C ticks, each with the mean-motion prediction in-kernel: the yaw wraps by
// conditional subtraction and (cos, sin) advance by angle addition from the
// tick's exact (cos, sin) of rot_eff, not renormalized.  noise is [C, 3, P];
// motion and prior are [C, 4].  The tile stays in shared memory for the C
// ticks; every thread of a block takes part in loading each tick's tables,
// so threads past P stay until the end.
template <bool EVIDENCE>
__global__ void fused_fs2_planes_multi_kernel(
    const float* __restrict__ poses, const float* __restrict__ cyaw_in,
    const float* __restrict__ syaw_in, const float* __restrict__ logw_in,
    const float* __restrict__ noise, const float* __restrict__ motion,
    const float* __restrict__ prior, float* __restrict__ mx, float* __restrict__ my,
    float* __restrict__ ca, float* __restrict__ cb, float* __restrict__ cd,
    int* __restrict__ cnt_io, const float* __restrict__ z4,
    const int* __restrict__ zvalid, const int* __restrict__ mlast,
    float* __restrict__ tx, float* __restrict__ ty, float* __restrict__ tyaw,
    float* __restrict__ tlogw, const int P, const int L, const int M, const int C,
    const int G, const Params prm) {
  extern __shared__ float smem[];
  __shared__ int mtrip, rows;
  __shared__ float tab_s[8];  // motion (rot, trans, cos rot, sin rot) | prior
  const Lanes w = lanes_of(G);
  const TileBlock b = carve(smem, L, M, w.T);
  const size_t p0 = static_cast<size_t>(blockIdx.x) * w.T;
  stage_tile(b, rows, w, p0, P, L, mx, my, ca, cb, nullptr, cd, cnt_io);

  const size_t p = p0 + w.i;
  const bool active = p < static_cast<size_t>(P);
  TileColumn<false> s = column(b, w, L);
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
    __syncthreads();  // the previous tick's tables are no longer read
    const float* zk = z4 + static_cast<size_t>(k) * 4 * M;
    for (int i = threadIdx.x; i < 4 * M; i += blockDim.x) b.z[i] = zk[i];
    for (int i = threadIdx.x; i < M; i += blockDim.x) b.zv[i] = zvalid[k * M + i];
    if (threadIdx.x < 4) {
      tab_s[threadIdx.x] = motion[4 * k + threadIdx.x];
      tab_s[4 + threadIdx.x] = prior[4 * k + threadIdx.x];
    }
    if (threadIdx.x == 0) mtrip = min(mlast[k], M);
    __syncthreads();
    if (!active) continue;

    // mean-motion prediction
    yaw = wrap_pi(yaw + tab_s[0]);
    const float c2 = cyaw * tab_s[2] - syaw * tab_s[3];
    const float s2 = syaw * tab_s[2] + cyaw * tab_s[3];
    cyaw = c2;
    syaw = s2;
    px = px + tab_s[1] * cyaw;
    py = py + tab_s[1] * syaw;

    const size_t kp = static_cast<size_t>(k) * P + p;
    const float* nk = noise + static_cast<size_t>(k) * 3 * P + p;
    fs2_tick<EVIDENCE>(s, L, b.z, b.zv, mtrip, tab_s + 4, nk[0], nk[P],
                       nk[2 * static_cast<size_t>(P)], px, py, yaw, cyaw, syaw, cnt, logw,
                       prm);
    if (w.g == 0) {
      tx[kp] = px;
      ty[kp] = py;
      tyaw[kp] = yaw;
      tlogw[kp] = logw;
    }
  }
  if (active && w.g == 0) {
    cnt_io[p] = cnt;
    atomicMax(&rows, cnt);
  }
  __syncthreads();
  write_back(b, rows, w, p0, P, L, mx, my, ca, cb, nullptr, cd);
}

// The block's dynamic shared memory for a launch geometry of `tile`
// particles and `lanes` lanes per particle, or 0 if the kernels do not take
// it (core/cuda_kernels.py:fs2_launch_geometry checks the same).
size_t checked_shared_bytes(const int L, const int M, const int tile, const int lanes) {
  const size_t smem = tile_shared_bytes(L, M, tile);
  const bool lanes_ok = lanes == 1 || lanes == 2 || lanes == 4 || lanes == 8;
  if (L < 1 || L > 256 || M < 0 || tile < 32 || tile % 32 != 0 || !lanes_ok
      || tile * lanes > 1024 || smem + kStaticSmemBytes > kSmemOptInLimit) {
    return 0;
  }
  return smem;
}

}  // namespace

extern "C" {

int fused_fs2_planes_launch(
    int device, const float* pred, const float* cyaw, const float* syaw, float* logw,
    const float* noise, float* poses_out, float* mx, float* my, float* ca, float* cb,
    float* cd, int* cnt, const float* z4, const int* zvalid, const int* mlast,
    const float* prior, int P, int L, int M, int evidence, float gate2, int gate_thr,
    float meas_noise, float default_cov, float default_cov2, int tile, int lanes,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = checked_shared_bytes(L, M, tile, lanes);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  const Params prm{gate2, gate_thr, meas_noise, default_cov, default_cov2};
  const dim3 grid((P + tile - 1) / tile);
  auto kernel = evidence ? fused_fs2_planes_kernel<true> : fused_fs2_planes_kernel<false>;
  // above 48 KB a block's dynamic shared memory needs the opt-in, per instance
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, tile * lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      pred, cyaw, syaw, logw, noise, poses_out, mx, my, ca, cb, cd, cnt, z4, zvalid, mlast,
      prior, P, L, M, lanes, prm);
  return static_cast<int>(cudaGetLastError());
}

int fused_fs2_planes_multi_launch(
    int device, const float* poses, const float* cyaw, const float* syaw,
    const float* logw, const float* noise, const float* motion, const float* prior,
    float* mx, float* my, float* ca, float* cb, float* cd, int* cnt, const float* z4,
    const int* zvalid, const int* mlast, float* tx, float* ty, float* tyaw,
    float* tlogw, int P, int L, int M, int C, int evidence, float gate2, int gate_thr,
    float meas_noise, float default_cov, float default_cov2, int tile, int lanes,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = checked_shared_bytes(L, M, tile, lanes);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || C == 0) return 0;
  const Params prm{gate2, gate_thr, meas_noise, default_cov, default_cov2};
  const dim3 grid((P + tile - 1) / tile);
  auto kernel = evidence ? fused_fs2_planes_multi_kernel<true>
                         : fused_fs2_planes_multi_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, tile * lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      poses, cyaw, syaw, logw, noise, motion, prior, mx, my, ca, cb, cd, cnt, z4, zvalid,
      mlast, tx, ty, tyaw, tlogw, P, L, M, C, lanes, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
