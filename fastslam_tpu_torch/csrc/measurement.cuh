// Per-particle device code shared by the fused kernels (fused_update.cu,
// fused_fs2.cu): polynomial trig, the packed-argmin key and one measurement
// through association, 2x2 landmark EKF, append and weighting, over a view
// of the particle's landmark slots staged in shared memory (tile.cuh:
// TileColumn).
//
// Arithmetic follows the plain PyTorch versions (core/cuda_kernels.py) op for
// op.  Build with -fmad=false so no multiply-add is contracted; divisions and
// square roots are IEEE (no fast-math), and constants are double literals
// rounded to float, as Python scalars are.

#pragma once

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

// (sin x, cos x) for |x| <= pi: Cephes-style minimax polynomials on [0, pi/4]
// after quadrant and octant folding (the plain version's _sin_cos)
__device__ __forceinline__ void sin_cos_poly(float x, float& s, float& c) {
  const float y = fabsf(x);
  const float sign_s = x < 0.0f ? -1.0f : 1.0f;
  const bool hi = y > kHalfPi;
  const float z = hi ? kPi - y : y;
  const float sign_c = hi ? -1.0f : 1.0f;
  const bool octant = z > kQuarterPi;
  const float w = octant ? kHalfPi - z : z;
  const float ww = w * w;
  const float sp = ((((static_cast<float>(-1.9515295891e-4) * ww
                       + static_cast<float>(8.3321608736e-3)) * ww
                      - static_cast<float>(1.6666654611e-1)) * ww) * w) + w;
  const float cp = ((((((static_cast<float>(2.443315711809948e-5) * ww
                         - static_cast<float>(1.388731625493765e-3)) * ww
                        + static_cast<float>(4.166664568298827e-2)) * ww) * ww)
                     - 0.5f * ww) + 1.0f);
  s = sign_s * (octant ? cp : sp);
  c = sign_c * (octant ? sp : cp);
}

// Production association key of one usable slot: the squared Mahalanobis
// distance of (wx, wy) from the slot's landmark (clamped at 0) as float bits,
// 8 LSBs dropped, OR the slot; the smallest key is the nearest slot, ties to
// the lower one.  inv_det is 1 / det(cov) of the slot.
__device__ __forceinline__ int slot_key(
    const float mx, const float my, const float ca, const float cb, const float cc,
    const float cd, const float inv_det, const float wx, const float wy, const int l) {
  const float dx = mx - wx;
  const float dy = my - wy;
  const float d2f = dx * (cd * dx - cb * dy) + dy * (-cc * dx + ca * dy);
  const float dist2 = clamp_min(d2f * inv_det, 0.0f);
  return (__float_as_int(dist2) & ~0xFF) | l;
}

// One measurement for one particle, over its slots in the view `s`
// (tile.cuh: TileColumn), which offers
//   argmin(wx, wy, cnt)           production: the smallest packed key over
//                                 the usable slots, kInvalidKey if none;
//   first_hit(qx, qy, gate2, cnt) parity: the first usable slot under the
//                                 gate, L if none;
//   load<PARITY>(l, ...)          slot l's mean and covariance;
//   store<PARITY>(l, ..., det)    write slot l and its det(cov);
//   sync()                        make the stores visible to the particle's
//                                 next loads.
// WEIGHT adds the measurement log-likelihood to logw; the FastSLAM 2.0
// kernels turn it off when the proposal's evidence carries the weight.
template <bool PARITY, bool WEIGHT, class Slots>
__device__ __forceinline__ void apply_measurement(
    Slots& s, const int L,
    const float px, const float py, const float yaw, const float cyaw, const float syaw,
    const float dist_z, const float bearing_z, const float cos_b, const float sin_b,
    const bool z_ok, int& cnt, float& logw, const Params& prm) {
  // world-frame observation by angle addition
  const float wx = px + dist_z * (cyaw * cos_b - syaw * sin_b);
  const float wy = py + dist_z * (syaw * cos_b + cyaw * sin_b);

  int idx;
  bool has_match;
  if constexpr (PARITY) {
    // first hit under the gate, against the robot-frame observation
    idx = s.first_hit(dist_z * cos_b, dist_z * sin_b, prm.gate2, cnt);
    has_match = idx < L;
  } else {
    const int kmin = s.argmin(wx, wy, cnt);
    has_match = kmin <= prm.gate_thr;
    idx = kmin & 0xFF;
  }

  const bool do_update = has_match && z_ok;
  const bool do_append = !has_match && cnt < L && z_ok;
  if (do_update) {
    float mu_x, mu_y, a, b, c, d;
    s.template load<PARITY>(idx, mu_x, mu_y, a, b, c, d);

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

    s.template store<PARITY>(idx, mu_x + k00 * nu_r + k01 * nu_b,
                             mu_y + k10 * nu_r + k11 * nu_b, new_a, new_b, new_c, new_d,
                             new_a * new_d - new_b * new_c);
    if (WEIGHT) {
      const float maha = i00 * nu_r * nu_r + (i01 + i10) * nu_r * nu_b + i11 * nu_b * nu_b;
      const float log_lik =
          -0.5f * (maha + logf(clamp_min(s_det, static_cast<float>(1e-30)))) - kLogTwoPi;
      logw = logw + log_lik;
    }
  } else if (do_append) {
    s.template store<PARITY>(cnt, wx, wy, prm.default_cov, 0.0f, 0.0f, prm.default_cov,
                             prm.default_cov2);
    cnt += 1;
  }
  s.sync();
}

}  // namespace
