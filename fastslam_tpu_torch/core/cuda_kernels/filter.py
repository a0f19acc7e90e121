"""The four filter kernels and their plain PyTorch versions (rows 1-4).

* the motion proposal: one tick (:func:`fused_update_planes`) or C ticks
  with in-kernel propagation (:func:`fused_update_planes_multi`) of
  association, 2x2 landmark EKF, append and weight update for every
  particle (``csrc/fused_update.cu``);
* the FastSLAM 2.0 proposal: one tick (:func:`fused_fs2_planes`) or C ticks
  with in-kernel mean-motion prediction (:func:`fused_fs2_planes_multi`) of
  proposal accumulation at the predicted pose, pose solve and sample, and
  the landmark EKF at the sampled pose (``csrc/fused_fs2.cu``).

:func:`fused_update` is the blocks-layout (``[P, L, k]``) entry of the
per-tick motion kernel: it transposes to planes and back, as the JAX
package's wrapper of the same name does.

The four kernels stage a tile of particles' planes in shared memory for
the tick (the per-tick kernels) or the chunk (the chunked ones), with a
few lanes per particle (:func:`fs2_launch_geometry`,
:func:`motion_launch_geometry`; ``csrc/tile.cuh``), and share their
per-measurement device code (``csrc/measurement.cuh``).
"""

from __future__ import annotations

import ctypes
import math
import struct
from typing import Optional, Tuple

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core.cuda_kernels._launch import (
    SMEM_OPT_IN_BYTES, launch, ptr, require_cuda,
)

_LOG_TWO_PI = math.log(2.0 * math.pi)
_PI = math.pi

# packed-argmin sentinel: +inf bits with all slot bits set, larger than any
# usable (finite, non-negative) distance key
_INVALID_KEY = 0x7F8000FF

# the most shared memory any kernel declares statically (trip count, rows,
# motion and prior rows)
_STATIC_SMEM_BYTES = 64
# the fs2 kernels' launch geometry: particles per block (the tile staged in
# shared memory) and lanes per particle, chosen by timing the candidates at
# P = 100,000, L = 64, M = 16 (chip_smoke.py phase 9, PERF.md §6)
FS2_TILE, FS2_LANES = 32, 4
# the motion kernels' launch geometry (per tick and chunked), timed the same
# way (phase 9)
MOTION_TILE, MOTION_LANES = 32, 4


def _f32_bits(x: float) -> int:
    """Bit pattern of a non-negative float32 as a Python int."""
    return struct.unpack("<i", struct.pack("<f", float(x)))[0]


# ---------------------------------------------------------------------------
# polynomial trig, shared with the kernels (csrc/measurement.cuh)
# ---------------------------------------------------------------------------

def _atan_poly(x: torch.Tensor) -> torch.Tensor:
    """Cephes-style single-precision atan for x >= 0 (max err ~1e-7 rad).
    Range reduction: x > tan(3pi/8) -> pi/2 - atan(1/x);
    x > tan(pi/8) -> pi/4 + atan((x-1)/(x+1))."""
    t3p8 = 2.414213562373095  # tan(3*pi/8)
    tp8 = 0.4142135623730950  # tan(pi/8)
    big = x > t3p8
    mid = (x > tp8) & ~big
    xr = torch.where(big, -1.0 / torch.where(x == 0.0, 1.0, x),
                     torch.where(mid, (x - 1.0) / (x + 1.0), x))
    base = torch.where(big, _PI / 2.0, torch.where(mid, _PI / 4.0, 0.0))
    z = xr * xr
    p = (((8.05374449538e-2 * z - 1.38776856032e-1) * z + 1.99777106478e-1)
         * z - 3.33329491539e-1) * z * xr + xr
    return base + p


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 from the polynomial atan, quadrant-corrected."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    safe_ax = torch.where(ax == 0.0, 1.0, ax)
    a = _atan_poly(ay / safe_ax)              # angle in [0, pi/2) vs +x axis
    a = torch.where(ax == 0.0, _PI / 2.0, a)  # on the y axis
    a = torch.where(x < 0.0, _PI - a, a)      # left half-plane
    a = torch.where(y < 0.0, -a, a)           # lower half-plane
    a = torch.where((y == 0.0) & (x < 0.0), _PI, a)
    a = torch.where((y == 0.0) & (x >= 0.0), 0.0, a)
    return a


def _wrap_pi(x: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi] for |x| < 3*pi by conditional subtraction (not a
    modulo: the result differs from ``wrap_angle`` in the last bits)."""
    for _ in range(2):
        x = torch.where(x > _PI, x - 2.0 * _PI, x)
        x = torch.where(x < -_PI, x + 2.0 * _PI, x)
    return x


def _sin_cos(x: torch.Tensor):
    """Single-precision (sin, cos) for |x| <= pi: Cephes-style minimax
    polynomials with branch-free quadrant and octant folding (max error
    ~1 ulp).  The fs2 kernels take the sampled yaw's cos/sin from it."""
    y = torch.abs(x)
    sign_s = torch.where(x < 0.0, -1.0, 1.0)
    # quadrant fold: sin(pi - y) = sin(y), cos(pi - y) = -cos(y)
    hi = y > _PI / 2.0
    z = torch.where(hi, _PI - y, y)
    sign_c = torch.where(hi, -1.0, 1.0)
    # octant fold to [0, pi/4]: sin(z) = cos(pi/2 - z) and vice versa
    octant = z > _PI / 4.0
    w = torch.where(octant, _PI / 2.0 - z, z)
    ww = w * w
    sp = ((-1.9515295891e-4 * ww + 8.3321608736e-3) * ww
          - 1.6666654611e-1) * ww * w + w
    cp = ((2.443315711809948e-5 * ww - 1.388731625493765e-3) * ww
          + 4.166664568298827e-2) * ww * ww - 0.5 * ww + 1.0
    sin_z = torch.where(octant, cp, sp)
    cos_z = torch.where(octant, sp, cp)
    return sign_s * sin_z, sign_c * cos_z


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _measurement_table(z: torch.Tensor, z_valid: torch.Tensor):
    """``[..., M, 4]`` (distance, bearing, cos b, sin b), int32 valid flags
    and the per-tick trip count (last valid index + 1, 0 if none)."""
    m = z.shape[-2]
    z = z.to(torch.float32)
    z4 = torch.cat([z, torch.cos(z[..., 1:2]), torch.sin(z[..., 1:2])], dim=-1)
    ranks = torch.arange(1, m + 1, dtype=torch.int32, device=z.device)
    mlast = torch.where(z_valid, ranks, 0).amax(dim=-1).to(torch.int32)
    return z4.contiguous(), z_valid.to(torch.int32).contiguous(), mlast


def _initial_detp(slot, cnt, ca, cb, cc, cd):
    """Det/validity plane: > 0 iff the slot is occupied and det(cov) > 0;
    empty slots are pinned to -1."""
    return torch.where(slot < cnt, ca * cd - cb * cc, -1.0)


def _packed_argmin(d2f, detp, slot, gate: float):
    """Production association: the best slot under the gate.

    The non-negative distance's float bits order like the distance; drop 8
    mantissa bits and OR the slot into them, so one int32 min gives the
    winner and its slot (ties -> lower slot).  Returns ``(has_match, idx)``
    as ``[1, P]`` rows."""
    usable = detp > 0.0
    inv_det = 1.0 / torch.where(usable, detp, 1.0)
    dist2 = torch.clamp_min(d2f * inv_det, 0.0)
    key = dist2.view(torch.int32)
    key = torch.where(usable, (key & ~0xFF) | slot, _INVALID_KEY)
    kmin = key.amin(dim=0, keepdim=True)
    gate_bits = _f32_bits(gate * gate)
    has_match = kmin <= (((gate_bits - 1) & ~0xFF) | 0xFF)
    return has_match, kmin & 0xFF


def _apply_measurement(carry, pose_rows, z_row, *, slot, config: FastSLAMConfig,
                       weight_update: bool = True):
    """One measurement through association, 2x2 EKF, append and weighting
    for all particles (``[L, P]`` planes, ``[1, P]`` rows) — what
    ``pallas_kernels._apply_measurement`` computes, and what
    ``apply_measurement`` in ``csrc/measurement.cuh`` computes per thread.
    ``weight_update=False`` runs the EKF without adding the measurement
    likelihood to the weights (the FastSLAM 2.0 evidence carries it).

    carry:     (mx, my, ca, cb, cc, cd, detp, cnt, logw); ``cc is cb`` in
               production mode, where the covariance stays symmetric
    pose_rows: (px, py, yaw, cyaw, syaw)
    z_row:     (distance, bearing, cos b, sin b, valid) 0-d tensors
    """
    mx, my, ca, cb, cc, cd, detp, cnt, logw = carry
    px, py, yaw, cyaw, syaw = pose_rows
    dist_z, bearing_z, cos_b, sin_b, z_ok = z_row
    parity = config.parity_mode
    gate = float(config.max_landmark_distance)
    meas_noise = float(config.measurement_noise)
    default_cov = float(config.default_landmark_cov)
    l = mx.shape[0]

    # world-frame observation by angle addition
    wx = px + dist_z * (cyaw * cos_b - syaw * sin_b)
    wy = py + dist_z * (syaw * cos_b + cyaw * sin_b)
    if parity:
        qx = dist_z * cos_b                 # robot-frame association quirk
        qy = dist_z * sin_b
        dx_q = mx - qx
        dy_q = my - qy
    else:
        dx_q = mx - wx
        dy_q = my - wy
    d2f = dx_q * (cd * dx_q - cb * dy_q) + dy_q * (-cc * dx_q + ca * dy_q)

    if parity:
        # first hit under the gate, without a divide: d2/det < g^2 (det > 0)
        hit = (detp > 0.0) & (d2f < (gate * gate) * detp)
        idx = torch.where(hit, slot, l).amin(dim=0, keepdim=True)
        has_match = idx < l
    else:
        has_match, idx = _packed_argmin(d2f, detp, slot, gate)

    # matched slot by direct index (the value is unused without a match)
    gi = idx.clamp(max=l - 1).long()
    mu_x = mx.gather(0, gi)
    mu_y = my.gather(0, gi)
    a = ca.gather(0, gi)
    b = cb.gather(0, gi)
    c = cc.gather(0, gi) if parity else b
    d = cd.gather(0, gi)

    dx = mu_x - px
    dy = mu_y - py
    q = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    rinv = 1.0 / torch.sqrt(q)   # exact, as the kernel computes it
    qinv = rinv * rinv
    r = q * rinv
    nu_r = dist_z - r
    nu_b = _wrap_pi(bearing_z + yaw - _atan2(dy, dx))

    h00 = dx * rinv
    h01 = dy * rinv
    h10 = -dy * qinv
    h11 = dx * qinv

    u0 = h00 * a + h01 * c
    u1 = h00 * b + h01 * d
    v0 = h10 * a + h11 * c
    v1 = h10 * b + h11 * d
    s00 = u0 * h00 + u1 * h01 + meas_noise
    s01 = u0 * h10 + u1 * h11
    s10 = v0 * h00 + v1 * h01
    s11 = v0 * h10 + v1 * h11 + meas_noise

    s_det = s00 * s11 - s01 * s10
    # sign(0) == 0 here, as in the reference (not copysign)
    s_det_safe = torch.clamp_min(torch.abs(s_det), 1e-18) * torch.sign(s_det + 1e-30)
    sdi = 1.0 / s_det_safe
    i00 = s11 * sdi
    i01 = -s01 * sdi
    i10 = -s10 * sdi
    i11 = s00 * sdi

    m0 = a * h00 + b * h01
    m1 = c * h00 + d * h01
    n0 = a * h10 + b * h11
    n1 = c * h10 + d * h11
    k00 = m0 * i00 + n0 * i10
    k01 = m0 * i01 + n0 * i11
    k10 = m1 * i00 + n1 * i10
    k11 = m1 * i01 + n1 * i11

    new_mu_x = mu_x + k00 * nu_r + k01 * nu_b
    new_mu_y = mu_y + k10 * nu_r + k11 * nu_b

    g00 = 1.0 - (k00 * h00 + k01 * h10)
    g01 = -(k00 * h01 + k01 * h11)
    g10 = -(k10 * h00 + k11 * h10)
    g11 = 1.0 - (k10 * h01 + k11 * h11)
    new_a = g00 * a + g01 * c
    new_b = g00 * b + g01 * d
    new_c = g10 * a + g11 * c
    new_d = g10 * b + g11 * d
    if not parity:
        off = 0.5 * (new_b + new_c)
        new_b = off
        new_c = off

    maha = i00 * nu_r * nu_r + (i01 + i10) * nu_r * nu_b + i11 * nu_b * nu_b
    log_lik = -0.5 * (maha + torch.log(torch.clamp_min(s_det, 1e-30))) - _LOG_TWO_PI

    do_update = has_match & z_ok                              # [1, P]
    do_append = (~has_match) & (cnt < l) & z_ok
    # at most one slot per particle is written: the matched one (update)
    # or slot == cnt (append)
    tgt = ((slot == idx) & do_update) | ((slot == cnt) & do_append)

    row = lambda u, v: torch.where(do_update, u, v)
    mx = torch.where(tgt, row(new_mu_x, wx), mx)
    my = torch.where(tgt, row(new_mu_y, wy), my)
    ca = torch.where(tgt, row(new_a, default_cov), ca)
    cb = torch.where(tgt, row(new_b, 0.0), cb)
    cc = torch.where(tgt, row(new_c, 0.0), cc) if parity else cb
    cd = torch.where(tgt, row(new_d, default_cov), cd)
    new_det = new_a * new_d - new_b * new_c
    detp = torch.where(tgt, row(new_det, default_cov * default_cov), detp)
    cnt = cnt + do_append.to(torch.int32)
    if weight_update:
        logw = torch.where(do_update, logw + log_lik, logw)
    return mx, my, ca, cb, cc, cd, detp, cnt, logw


def _z_row(z4, zvalid, m: int):
    return (z4[m, 0], z4[m, 1], z4[m, 2], z4[m, 3], zvalid[m] > 0)


def _measurement_loop(carry, pose_rows, z4, zvalid, mlast: int, slot, config,
                      weight_update: bool = True):
    for m in range(mlast):
        carry = _apply_measurement(carry, pose_rows, _z_row(z4, zvalid, m),
                                   slot=slot, config=config,
                                   weight_update=weight_update)
    return carry


def _start(poses, log_weights, planes, lm_count, config):
    """Slot column, pose rows and loop carry of the plain versions."""
    lm_mx, lm_my, lm_ca, lm_cb, lm_cc, lm_cd = planes
    l, p = lm_mx.shape
    cc = lm_cc if config.parity_mode else lm_cb
    slot = torch.arange(l, dtype=torch.int32, device=poses.device)[:, None]
    cnt = lm_count.reshape(1, p)
    yaw = poses[:, 2].reshape(1, p)
    rows = (poses[:, 0].reshape(1, p), poses[:, 1].reshape(1, p), yaw,
            torch.cos(yaw), torch.sin(yaw))
    detp = _initial_detp(slot, cnt, lm_ca, lm_cb, cc, lm_cd)
    carry = (lm_mx, lm_my, lm_ca, lm_cb, cc, lm_cd, detp, cnt,
             log_weights.reshape(1, p))
    return slot, rows, carry


def _finish(planes, lm_count, carry, config):
    """Write the carry's planes and counts back in place, as the kernels do;
    returns the planes with ``cc`` None in production mode."""
    planes = tuple(planes[:4]) + (planes[4] if config.parity_mode else None, planes[5])
    for dst, src in zip(planes, carry[:6]):
        if dst is not None:
            dst.copy_(src)
    lm_count.copy_(carry[7].reshape(-1))
    return planes


def fused_update_planes_ref(poses, log_weights, lm_mx, lm_my, lm_ca, lm_cb,
                            lm_cc, lm_cd, lm_count, z, z_valid,
                            config: FastSLAMConfig):
    """Plain PyTorch version of :func:`fused_update_planes` (same contract)."""
    planes = (lm_mx, lm_my, lm_ca, lm_cb, lm_cc, lm_cd)
    _check_inputs(poses, log_weights, planes, lm_count, z, z_valid, config)
    z4, zvalid, mlast = _measurement_table(z, z_valid)
    slot, rows, carry = _start(poses, log_weights, planes, lm_count, config)
    carry = _measurement_loop(carry, rows, z4, zvalid, int(mlast), slot, config)
    log_weights.copy_(carry[8].reshape(-1))
    return (log_weights, *_finish(planes, lm_count, carry, config), lm_count)


def _propagate_rows(px, py, yaw, cyaw, syaw, nrot, ntrans, cnr, snr):
    """In-kernel propagation of one tick: yaw wraps by conditional
    subtraction, (cos, sin) of yaw advance by angle addition from the exact
    cos/sin of the rotation and are renormalized, and the translation runs
    along the new heading."""
    yaw = _wrap_pi(yaw + nrot)
    cyaw, syaw = cyaw * cnr - syaw * snr, syaw * cnr + cyaw * snr
    inv_n = 1.0 / torch.sqrt(cyaw * cyaw + syaw * syaw)
    cyaw = cyaw * inv_n
    syaw = syaw * inv_n
    px = px + ntrans * cyaw
    py = py + ntrans * syaw
    return px, py, yaw, cyaw, syaw


def fused_update_planes_multi_ref(poses, log_weights, lm_mx, lm_my, lm_ca,
                                  lm_cb, lm_cc, lm_cd, lm_count, z, z_valid,
                                  noisy_rot, noisy_trans,
                                  config: FastSLAMConfig):
    """Plain PyTorch version of :func:`fused_update_planes_multi` (same contract)."""
    planes = (lm_mx, lm_my, lm_ca, lm_cb, lm_cc, lm_cd)
    _check_multi_inputs(poses, log_weights, planes, lm_count, z, z_valid,
                        noisy_rot, noisy_trans, config)
    c, p = noisy_rot.shape
    z4, zvalid, mlast = _measurement_table(z, z_valid)
    slot, rows, carry = _start(poses, log_weights, planes, lm_count, config)
    cnr, snr = torch.cos(noisy_rot), torch.sin(noisy_rot)
    traj = torch.empty((4, c, p), dtype=poses.dtype, device=poses.device)
    for k, mtrip in enumerate(mlast.tolist()):
        rows = _propagate_rows(*rows, noisy_rot[k], noisy_trans[k], cnr[k], snr[k])
        carry = _measurement_loop(carry, rows, z4[k], zvalid[k], mtrip, slot, config)
        traj[:3, k] = torch.cat(rows[:3])
        traj[3, k] = carry[8][0]
    return (*traj, *_finish(planes, lm_count, carry, config), lm_count)


# ---------------------------------------------------------------------------
# plain versions: the FastSLAM 2.0 proposal
# ---------------------------------------------------------------------------

def _proposal_prior_rows(cy, sy, s_t2, s_r2, fxy):
    """Motion-prior covariance rows and the information-form start of the
    pose Lambda: ``((p00, p01, p11, s_r2), (lam00 .. lam22))``."""
    p00 = cy * cy * s_t2 + sy * sy * fxy
    p01 = cy * sy * (s_t2 - fxy)
    p11 = sy * sy * s_t2 + cy * cy * fxy
    det_p = p00 * p11 - p01 * p01
    i_p = 1.0 / torch.clamp_min(det_p, 1e-18)
    zero = torch.zeros_like(p00)
    lam = (p11 * i_p, -p01 * i_p, zero, p00 * i_p, zero,
           (1.0 / s_r2) * torch.ones_like(p00))
    return (p00, p01, p11, s_r2 * torch.ones_like(p00)), lam


def _accumulate_proposal(acc, planes, pred_rows, prior_rows, z_row, *, slot,
                         gate: float, meas_noise: float, evidence: bool, scale):
    """One measurement of the proposal accumulation at the predicted pose —
    what ``pallas_kernels._accumulate_proposal`` computes, and what
    ``accumulate_proposal`` in ``csrc/fused_fs2.cu`` computes per thread:
    production packed-argmin association, the Gauss-Newton terms of the pose
    information (Lambda, eta) behind the 9.21 chi^2 gate, scaled by the mode
    dial ``scale``, and (``evidence``) the evidence log-weight, which the
    dial does not scale.

    acc:        (lam00 lam01 lam02 lam11 lam12 lam22, e0 e1 e2, logw_add)
    planes:     (mx, my, ca, cb, cd, detp), read only (cc == cb)
    pred_rows:  (px, py, yaw, cyaw, syaw) of the predicted pose
    prior_rows: (p00, p01, p11, s_r2)
    """
    lam00, lam01, lam02, lam11, lam12, lam22, e0a, e1a, e2a, logw_add = acc
    mx, my, ca, cb, cd, detp = planes
    cc = cb
    px, py, yaw, cyaw, syaw = pred_rows
    p00, p01, p11, s_r2 = prior_rows
    dist_z, bearing_z, cos_b, sin_b, z_ok = z_row
    l = mx.shape[0]

    wx = px + dist_z * (cyaw * cos_b - syaw * sin_b)
    wy = py + dist_z * (syaw * cos_b + cyaw * sin_b)
    dx_q = mx - wx
    dy_q = my - wy
    d2f = dx_q * (cd * dx_q - cb * dy_q) + dy_q * (-cc * dx_q + ca * dy_q)
    has_match, idx = _packed_argmin(d2f, detp, slot, gate)
    use = has_match & z_ok

    # the matched landmark, zeros without a match (gated below)
    gi = idx.clamp(max=l - 1).long()
    take = lambda plane: torch.where(has_match, plane.gather(0, gi), 0.0)
    mu_x, mu_y, a, b, d = take(mx), take(my), take(ca), take(cb), take(cd)
    c = b

    dx = mu_x - px
    dy = mu_y - py
    q = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    rinv = 1.0 / torch.sqrt(q)
    qinv = rinv * rinv
    r = q * rinv
    nu_r = dist_z - r
    nu_b = _wrap_pi(bearing_z + yaw - _atan2(dy, dx))

    # landmark-side innovation covariance S~ = Hm Sig Hm' + R
    h00 = dx * rinv
    h01 = dy * rinv
    h10 = -dy * qinv
    h11 = dx * qinv
    u0 = h00 * a + h01 * c
    u1 = h00 * b + h01 * d
    v0 = h10 * a + h11 * c
    v1 = h10 * b + h11 * d
    s00 = u0 * h00 + u1 * h01 + meas_noise
    s01 = u0 * h10 + u1 * h11
    s11 = v0 * h10 + v1 * h11 + meas_noise
    s_det = torch.clamp_min(s00 * s11 - s01 * s01, 1e-18)
    si = 1.0 / s_det
    i00 = s11 * si
    i01 = -s01 * si
    i11 = s00 * si

    # chi^2 innovation gate (99 %, 2 dof): a likely mis-association may
    # down-weight the particle but must not pull the proposal
    maha_gate = i00 * nu_r * nu_r + 2.0 * i01 * nu_r * nu_b + i11 * nu_b * nu_b
    use = use & (maha_gate < 9.21)

    # pose Jacobian Hx = [[-dx/r, -dy/r, 0], [dy/q, -dx/q, -1]]
    g00, g01 = -h00, -h01
    g10, g11 = -h10, -h11
    # Hx' S~^-1 Hx (symmetric 3x3) and Hx' S~^-1 nu (g02 = 0, g12 = -1)
    t00 = i00 * g00 + i01 * g10
    t01 = i00 * g01 + i01 * g11
    t02 = -i01
    t10 = i01 * g00 + i11 * g10
    t11 = i01 * g01 + i11 * g11
    t12 = -i11
    d00 = g00 * t00 + g10 * t10
    d01 = g00 * t01 + g10 * t11
    d02 = g00 * t02 + g10 * t12
    d11 = g01 * t01 + g11 * t11
    d12 = g01 * t02 + g11 * t12
    d22 = -t12
    e0 = t00 * nu_r + t10 * nu_b
    e1 = t01 * nu_r + t11 * nu_b
    e2 = t02 * nu_r + t12 * nu_b

    luse = use.to(mx.dtype) * scale
    lam00 = lam00 + luse * d00
    lam01 = lam01 + luse * d01
    lam02 = lam02 + luse * d02
    lam11 = lam11 + luse * d11
    lam12 = lam12 + luse * d12
    lam22 = lam22 + luse * d22
    e0a = e0a + luse * e0
    e1a = e1a + luse * e1
    e2a = e2a + luse * e2

    if evidence:
        # evidence weight N(nu; 0, S~ + Hx P0 Hx'), the motion prior
        # P0 = [[p00, p01, 0], [p01, p11, 0], [0, 0, s_r2]] through Hx
        q00 = g00 * (p00 * g00 + p01 * g01) + g01 * (p01 * g00 + p11 * g01)
        q01 = g00 * (p00 * g10 + p01 * g11) + g01 * (p01 * g10 + p11 * g11)
        q11 = (g10 * (p00 * g10 + p01 * g11)
               + g11 * (p01 * g10 + p11 * g11) + s_r2)
        z00 = s00 + q00
        z01 = s01 + q01
        z11 = s11 + q11
        z_det = torch.clamp_min(z00 * z11 - z01 * z01, 1e-30)
        zi = 1.0 / z_det
        maha = (z11 * nu_r * nu_r - 2.0 * z01 * nu_r * nu_b
                + z00 * nu_b * nu_b) * zi
        log_ev = -0.5 * (maha + torch.log(z_det)) - _LOG_TWO_PI
        logw_add = torch.where(use, logw_add + log_ev, logw_add)
    return lam00, lam01, lam02, lam11, lam12, lam22, e0a, e1a, e2a, logw_add


def _solve_sample_pose(lam, eta, pred_rows, noise_rows):
    """Sigma = Lambda^-1 (closed-form 3x3), mu = pred + Sigma eta, pose =
    mu + chol(Sigma + 1e-9 I) n, the yaw wrapped to (-pi, pi]."""
    l00, l01, l02, l11, l12, l22 = lam
    e0, e1, e2 = eta
    px, py, yaw = pred_rows
    n0, n1, n2 = noise_rows

    co00 = l11 * l22 - l12 * l12
    co01 = l02 * l12 - l01 * l22
    co02 = l01 * l12 - l02 * l11
    det = l00 * co00 + l01 * co01 + l02 * co02
    det = torch.where(torch.abs(det) > 1e-18, det, 1e-18)
    inv_det = 1.0 / det
    s00 = co00 * inv_det
    s01 = co01 * inv_det
    s02 = co02 * inv_det
    s11 = (l00 * l22 - l02 * l02) * inv_det
    s12 = (l01 * l02 - l00 * l12) * inv_det
    s22 = (l00 * l11 - l01 * l01) * inv_det

    mu0 = px + s00 * e0 + s01 * e1 + s02 * e2
    mu1 = py + s01 * e0 + s11 * e1 + s12 * e2
    mu2 = yaw + s02 * e0 + s12 * e1 + s22 * e2

    a = s00 + 1e-9
    d = s11 + 1e-9
    f = s22 + 1e-9
    c00 = torch.sqrt(torch.clamp_min(a, 1e-18))
    c10 = s01 / c00
    c20 = s02 / c00
    c11 = torch.sqrt(torch.clamp_min(d - c10 * c10, 1e-18))
    c21 = (s12 - c20 * c10) / c11
    c22 = torch.sqrt(torch.clamp_min(f - c20 * c20 - c21 * c21, 1e-18))

    new_x = mu0 + c00 * n0
    new_y = mu1 + c10 * n0 + c11 * n1
    new_yaw = _wrap_pi(mu2 + c20 * n0 + c21 * n1 + c22 * n2)
    return new_x, new_y, new_yaw


def _fs2_tick(carry, pred_rows, z4, zvalid, mtrip: int, slot, prior, noise_rows,
              config: FastSLAMConfig):
    """One fs2 tick of the plain versions: accumulate over the tick's
    measurements at the predicted pose, solve and sample, then the landmark
    EKF at the sampled pose.  ``prior`` is the tick's (s_t2, s_r2, fxy, dial)
    row.  Returns the sampled pose rows and the carry."""
    evidence = bool(config.fs2_evidence_weights)
    mx, my, ca, cb, cc, cd, detp, cnt, logw = carry
    prior_rows, lam = _proposal_prior_rows(pred_rows[3], pred_rows[4],
                                           prior[0], prior[1], prior[2])
    zero = torch.zeros_like(logw)
    acc = lam + (zero, zero, zero, zero)
    for m in range(mtrip):
        acc = _accumulate_proposal(
            acc, (mx, my, ca, cb, cd, detp), pred_rows, prior_rows,
            _z_row(z4, zvalid, m), slot=slot,
            gate=float(config.max_landmark_distance),
            meas_noise=float(config.measurement_noise), evidence=evidence,
            scale=prior[3])
    if evidence:
        logw = logw + acc[9]
    x, y, yaw = _solve_sample_pose(acc[:6], acc[6:9], pred_rows[:3], noise_rows)
    syaw, cyaw = _sin_cos(yaw)
    rows = (x, y, yaw, cyaw, syaw)
    carry = _measurement_loop((mx, my, ca, cb, cc, cd, detp, cnt, logw), rows,
                              z4, zvalid, mtrip, slot, config,
                              weight_update=not evidence)
    return rows, carry


def fused_fs2_planes_ref(pred_poses, log_weights, lm_mx, lm_my, lm_ca, lm_cb,
                         lm_cc, lm_cd, lm_count, z, z_valid, noise, s_t2, s_r2,
                         fxy, config: FastSLAMConfig, *, evidence_scale=None):
    """Plain PyTorch version of :func:`fused_fs2_planes` (same contract)."""
    planes = (lm_mx, lm_my, lm_ca, lm_cb, None, lm_cd)
    _check_fs2_inputs(pred_poses, log_weights, planes, lm_count, z, z_valid,
                      config)
    p = lm_mx.shape[1]
    _check_noise(noise, (p, 3), pred_poses.device)
    z4, zvalid, mlast = _measurement_table(z, z_valid)
    prior = _prior_table(s_t2, s_r2, fxy, evidence_scale, None, pred_poses.device)
    slot, rows, carry = _start(pred_poses, log_weights, planes, lm_count, config)
    noise_rows = tuple(noise[:, i].reshape(1, p) for i in range(3))
    rows, carry = _fs2_tick(carry, rows, z4, zvalid, int(mlast), slot, prior,
                            noise_rows, config)
    log_weights.copy_(carry[8].reshape(-1))
    poses = torch.stack([r.reshape(p) for r in rows[:3]], dim=-1)
    return (poses, log_weights, *_finish(planes, lm_count, carry, config), lm_count)


def fused_fs2_planes_multi_ref(poses, log_weights, lm_mx, lm_my, lm_ca, lm_cb,
                               lm_cc, lm_cd, lm_count, z, z_valid, noise,
                               rot_eff, trans_eff, s_t2, s_r2, fxy,
                               config: FastSLAMConfig, *, evidence_scale=None):
    """Plain PyTorch version of :func:`fused_fs2_planes_multi` (same contract)."""
    planes = (lm_mx, lm_my, lm_ca, lm_cb, None, lm_cd)
    _check_fs2_inputs(poses, log_weights, planes, lm_count, z, z_valid, config)
    if z.dim() != 3:
        raise ValueError(f"chunked measurements must be [C, M, 2], got {tuple(z.shape)}")
    c, p = z.shape[0], lm_mx.shape[1]
    device = poses.device
    _check_noise(noise, (c, 3, p), device)
    z4, zvalid, mlast = _measurement_table(z, z_valid)
    motion = _motion_table(rot_eff, trans_eff, c, device)
    prior = _prior_table(s_t2, s_r2, fxy, evidence_scale, c, device)
    slot, rows, carry = _start(poses, log_weights, planes, lm_count, config)
    traj = torch.empty((4, c, p), dtype=poses.dtype, device=device)
    for k, mtrip in enumerate(mlast.tolist()):
        # mean-motion prediction: the yaw wraps by conditional subtraction and
        # (cos, sin) advance by angle addition, not renormalized
        rot, trn, cr, sr = motion[k]
        px, py, yaw, cyaw, syaw = rows
        yaw = _wrap_pi(yaw + rot)
        cyaw, syaw = cyaw * cr - syaw * sr, syaw * cr + cyaw * sr
        pred = (px + trn * cyaw, py + trn * syaw, yaw, cyaw, syaw)
        rows, carry = _fs2_tick(carry, pred, z4[k], zvalid[k], mtrip, slot,
                                prior[k], tuple(noise[k, i:i + 1] for i in range(3)),
                                config)
        traj[:3, k] = torch.cat(rows[:3])
        traj[3, k] = carry[8][0]
    return (*traj, *_finish(planes, lm_count, carry, config), lm_count)


def _check_inputs(poses, log_weights, planes, lm_count, z, z_valid,
                  config: FastSLAMConfig):
    mx = planes[0]
    if mx.dim() != 2:
        raise ValueError(f"landmark planes must be [L, P], got {tuple(mx.shape)}")
    l, p = mx.shape
    if config.parity_mode:
        if planes[4] is None:
            raise ValueError("parity mode needs a real (asymmetric) lm_cc plane")
    elif l > 256:
        raise ValueError("packed argmin supports at most 256 landmark slots")
    device = poses.device
    floats = [poses, log_weights] + [t for t in planes if t is not None]
    for t in floats:
        if t.device != device or t.dtype != torch.float32:
            raise ValueError("poses, weights and planes must be float32 on "
                             f"{device}, got {t.dtype} on {t.device}")
    for t in planes:
        if t is not None and tuple(t.shape) != (l, p):
            raise ValueError(f"every plane must be [{l}, {p}], got {tuple(t.shape)}")
    if tuple(poses.shape) != (p, 3) or tuple(log_weights.shape) != (p,):
        raise ValueError(f"poses must be [{p}, 3] and log_weights [{p}]")
    if (lm_count.device != device or lm_count.dtype != torch.int32
            or tuple(lm_count.shape) != (p,)):
        raise ValueError(f"lm_count must be int32 [{p}] on {device}")
    if z.device != device or z_valid.device != device or z_valid.dtype != torch.bool:
        raise ValueError(f"measurements must lie on {device}, valid as bool")
    if z.shape[-1] != 2 or tuple(z_valid.shape) != tuple(z.shape[:-1]):
        raise ValueError("measurements must be [..., M, 2] with valid [..., M]")


def _check_multi_inputs(poses, log_weights, planes, lm_count, z, z_valid,
                        noisy_rot, noisy_trans, config):
    _check_inputs(poses, log_weights, planes, lm_count, z, z_valid, config)
    p = planes[0].shape[1]
    if z.dim() != 3:
        raise ValueError(f"chunked measurements must be [C, M, 2], got {tuple(z.shape)}")
    shape = (z.shape[0], p)
    for t in (noisy_rot, noisy_trans):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != poses.device):
            raise ValueError(f"noisy_rot/noisy_trans must be float32 {shape}")


def _check_fs2_inputs(poses, log_weights, planes, lm_count, z, z_valid,
                      config: FastSLAMConfig):
    if config.parity_mode:
        raise ValueError("the fs2 kernels run in production mode "
                         "(parity_mode=False)")
    _check_inputs(poses, log_weights, planes, lm_count, z, z_valid, config)


def _check_noise(noise, shape, device):
    if (tuple(noise.shape) != shape or noise.dtype != torch.float32
            or noise.device != device):
        raise ValueError(f"noise must be float32 {shape} on {device}, got "
                         f"{noise.dtype} {tuple(noise.shape)} on {noise.device}")


def _per_tick(value, c: Optional[int], device) -> torch.Tensor:
    """A scalar, or a ``[C]`` vector, as float32 of shape ``()`` or ``[C]``.
    A host number is filled on the device (no host-to-device copy, which a
    CUDA graph capture would refuse)."""
    t = (torch.as_tensor(value, dtype=torch.float32, device=device)
         if not isinstance(value, (int, float))
         else torch.full((), value, dtype=torch.float32, device=device))
    return t if c is None else t.broadcast_to((c,))


def _prior_table(s_t2, s_r2, fxy, evidence_scale, c: Optional[int], device):
    """The fs2 prior table (s_t2, s_r2, fxy, dial): ``[4]`` for one tick
    (``c=None``), ``[C, 4]`` for a chunk; ``evidence_scale=None`` means 1."""
    dial = 1.0 if evidence_scale is None else evidence_scale
    cols = [_per_tick(v, c, device) for v in (s_t2, s_r2, fxy, dial)]
    return torch.stack(cols, dim=-1).contiguous()


def _motion_table(rot_eff, trans_eff, c: int, device):
    """``[C, 4]`` (rot_eff, trans_eff, cos rot_eff, sin rot_eff), exact trig."""
    rot = _per_tick(rot_eff, c, device)
    return torch.stack([rot, _per_tick(trans_eff, c, device), torch.cos(rot),
                        torch.sin(rot)], dim=-1).contiguous()


def fs2_shared_bytes(l: int, m: int, tile: int) -> int:
    """Dynamic shared memory of an fs2 block of ``tile`` particles
    (``csrc/fused_fs2.cu``: ``tile_shared_bytes``): six ``[L, tile]`` planes
    (mx, my, ca, cb, cd, 1/det), the written bits ``[ceil(L / 32), tile]``,
    the counts ``[tile]``, the measurement table ``[M, 4]`` and its valid
    flags ``[M]``."""
    return 4 * (6 * l * tile + (l + 31) // 32 * tile + tile + 5 * m)


def fs2_launch_geometry(l: int, m: int) -> Tuple[int, int]:
    """``(tile, lanes)`` of the fs2 kernels at L slots and M measurements:
    ``tile`` particles per block, staged in shared memory, and ``lanes``
    threads per particle, which split its association scan.

    ``(FS2_TILE, FS2_LANES)``, the tile halved (down to 32) until the block
    fits the 227 KB a block may opt into; raises when no tile of 32 fits.
    The kernels take tiles of a multiple of 32 particles with 1, 2, 4 or 8
    lanes each (``csrc/fused_fs2.cu``: ``checked_shared_bytes``)."""
    tile, lanes = FS2_TILE, FS2_LANES
    if not 1 <= l <= 256:
        raise ValueError(f"the fs2 kernels take 1 to 256 landmark slots (the packed "
                         f"key's 8 slot bits), got {l}")
    fits = lambda t: fs2_shared_bytes(l, m, t) + _STATIC_SMEM_BYTES <= SMEM_OPT_IN_BYTES
    while tile > 32 and not fits(tile):
        tile = max(32, tile // 2 // 32 * 32)
    if not fits(tile):
        raise ValueError(f"{l} landmark slots and {m} measurements do not fit a "
                         f"32-particle fs2 tile in {SMEM_OPT_IN_BYTES} bytes of shared "
                         f"memory ({fs2_shared_bytes(l, m, 32)} needed)")
    return tile, lanes


def motion_shared_bytes(l: int, m: int, tile: int, parity: bool) -> int:
    """Dynamic shared memory of a motion block of ``tile`` particles
    (``csrc/tile.cuh``: ``tile_shared_bytes``): the fs2 layout's six planes
    in production, seven in parity (det(cov) in place of 1/det, and cc),
    then the written bits, counts and the measurement table."""
    planes = 7 if parity else 6
    return 4 * (planes * l * tile + (l + 31) // 32 * tile + tile + 5 * m)


def motion_launch_geometry(l: int, m: int, parity: bool) -> Tuple[int, int]:
    """``(tile, lanes)`` of the motion kernels (per tick and chunked) at L
    slots and M measurements: ``(MOTION_TILE, MOTION_LANES)``, the tile
    halved until the block fits the 227 KB a block may opt into, down to one
    warp of threads; raises when that does not fit.  The kernels take a tile
    of a multiple of 32 or a power of two below 32 particles, with a power
    of two up to ``min(tile, 32)`` lanes each, in whole warps
    (``csrc/fused_update.cu``: ``checked_motion_shared_bytes``, which both
    launchers call)."""
    tile, lanes = MOTION_TILE, MOTION_LANES
    if l < 1:
        raise ValueError(f"the motion kernel takes at least one landmark slot, got {l}")
    fits = lambda t: motion_shared_bytes(l, m, t, parity) + _STATIC_SMEM_BYTES \
        <= SMEM_OPT_IN_BYTES
    smallest = max(32 // lanes, lanes)
    while tile > smallest and not fits(tile):
        tile = tile // 2 if tile <= 32 else max(32, tile // 2 // 32 * 32)
    if not fits(tile):
        raise ValueError(f"{l} landmark slots and {m} measurements do not fit a "
                         f"{tile}-particle motion tile in {SMEM_OPT_IN_BYTES} bytes of "
                         f"shared memory ({motion_shared_bytes(l, m, tile, parity)} needed)")
    return tile, lanes


def _gate_args(config: FastSLAMConfig):
    gate = float(config.max_landmark_distance)
    dc = float(config.default_landmark_cov)
    gate_thr = ((_f32_bits(gate * gate) - 1) & ~0xFF) | 0xFF
    return (ctypes.c_float(gate * gate), ctypes.c_int(gate_thr),
            ctypes.c_float(config.measurement_noise), ctypes.c_float(dc),
            ctypes.c_float(dc * dc))


def fused_update_planes(poses, log_weights, lm_mx, lm_my, lm_ca, lm_cb, lm_cc,
                        lm_cd, lm_count, z, z_valid, config: FastSLAMConfig):
    """One tick of measurement updates for all particles.

    Args:
      poses ``[P, 3]``, log_weights ``[P]``; landmark planes ``[L, P]``
      (``lm_cc`` is ``None`` in production mode); lm_count ``[P]`` int32;
      z ``[M, 2]`` (distance, bearing); z_valid ``[M]`` bool.

    Returns ``(log_weights, mx, my, ca, cb, cc, cd, lm_count)``: the input
    tensors, updated in place (``cc`` is ``None`` in production mode).
    """
    if poses.device.type == "cpu":
        return fused_update_planes_ref(poses, log_weights, lm_mx, lm_my, lm_ca,
                                       lm_cb, lm_cc, lm_cd, lm_count, z,
                                       z_valid, config)
    planes = (lm_mx, lm_my, lm_ca, lm_cb, lm_cc if config.parity_mode else None, lm_cd)
    _check_inputs(poses, log_weights, planes, lm_count, z, z_valid, config)
    device = require_cuda(poses, log_weights, *planes, lm_count)
    if z.dim() != 2:
        raise ValueError(f"measurements must be [M, 2], got {tuple(z.shape)}")
    l, p = lm_mx.shape
    m = z.shape[0]
    tile, lanes = motion_launch_geometry(l, m, config.parity_mode)
    z4, zvalid, mlast = _measurement_table(z, z_valid)
    cyaw = torch.cos(poses[:, 2]).contiguous()
    syaw = torch.sin(poses[:, 2]).contiguous()
    cc = lm_cc if config.parity_mode else lm_cb
    launch(
        "fused_update_planes", device,
        ptr(poses), ptr(cyaw), ptr(syaw), ptr(log_weights),
        ptr(lm_mx), ptr(lm_my), ptr(lm_ca), ptr(lm_cb), ptr(cc), ptr(lm_cd),
        ptr(lm_count), ptr(z4), ptr(zvalid), ptr(mlast),
        ctypes.c_int(p), ctypes.c_int(l), ctypes.c_int(m),
        ctypes.c_int(int(config.parity_mode)), *_gate_args(config),
        ctypes.c_int(tile), ctypes.c_int(lanes),
    )
    return (log_weights, lm_mx, lm_my, lm_ca, lm_cb,
            lm_cc if config.parity_mode else None, lm_cd, lm_count)


def fused_update(poses, log_weights, lm_mean, lm_cov, lm_count, z, z_valid,
                 config: FastSLAMConfig):
    """One tick of measurement updates on the blocks layout: lm_mean
    ``[P, L, 2]``, lm_cov ``[P, L, 4]`` are transposed to ``[L, P]`` planes
    for :func:`fused_update_planes` and back, as ``state.to_planes`` and
    ``from_planes`` do, with no padding.  On CUDA tensors that launches the
    per-tick kernel; on the CPU it runs the kernel's plain version.  In
    production the kernel keeps no ``cc`` plane and ``cov[..., 2]`` comes
    back equal to ``cov[..., 1]``.

    ``lm_mean`` and ``lm_cov`` may also be sequences of slot blocks
    ``[P, L_m, 2]`` and ``[P, L_m, 4]`` in slot order (the map shards of one
    particle row of a 2-D mesh): each block's transpose is written into its
    row range of the planes, so the tick runs once over all ``L`` slots, and
    the result comes back as blocks of the same widths.

    Returns new ``(log_weights, lm_mean, lm_cov, lm_count)``; the inputs are
    not changed.
    """
    single = torch.is_tensor(lm_mean)
    means, covs = ([lm_mean], [lm_cov]) if single else (list(lm_mean), list(lm_cov))
    widths = [m.shape[1] for m in means]
    comps = ((0, 0), (0, 1), (1, 0), (1, 1)) + (((1, 2),) if config.parity_mode else ()) \
        + ((1, 3),)                                  # (mean or cov, component) per plane
    planes = [torch.empty((sum(widths), poses.shape[0]), dtype=means[0].dtype,
                          device=means[0].device) for _ in comps]
    start = 0
    for blocks in zip(means, covs):
        w = blocks[0].shape[1]
        for plane, (which, k) in zip(planes, comps):
            plane[start:start + w].copy_(blocks[which][:, :, k].t())
        start += w
    mx, my, ca, cb, *rest = planes
    cc, cd = rest if config.parity_mode else (None, rest[0])
    logw, mx, my, ca, cb, cc, cd, cnt = fused_update_planes(
        poses, log_weights.clone(), mx, my, ca, cb, cc, cd, lm_count.clone(), z, z_valid,
        config)
    cc = cb if cc is None else cc
    new_means, new_covs, start = [], [], 0
    for w in widths:
        rows = slice(start, start + w)
        new_means.append(torch.stack([mx[rows].t(), my[rows].t()], dim=-1))
        new_covs.append(torch.stack([ca[rows].t(), cb[rows].t(), cc[rows].t(), cd[rows].t()],
                                    dim=-1))
        start += w
    if single:
        return logw, new_means[0], new_covs[0], cnt
    return logw, new_means, new_covs, cnt


def fused_update_planes_multi(poses, log_weights, lm_mx, lm_my, lm_ca, lm_cb,
                              lm_cc, lm_cd, lm_count, z, z_valid, noisy_rot,
                              noisy_trans, config: FastSLAMConfig
                              ) -> Tuple[torch.Tensor, ...]:
    """C filter ticks (propagation + measurement updates) in one call.

    ``noisy_rot``/``noisy_trans`` ``[C, P]`` are the fully formed per-tick
    motion increments; z ``[C, M, 2]``, z_valid ``[C, M]``.  ``poses`` and
    ``log_weights`` are read only.

    Returns ``(tx, ty, tyaw, tlogw [C, P], mx, my, ca, cb, cc, cd,
    lm_count)``: new per-tick trajectories and the input planes and counts,
    updated in place (``cc`` is ``None`` in production mode).
    """
    if poses.device.type == "cpu":
        return fused_update_planes_multi_ref(poses, log_weights, lm_mx, lm_my,
                                             lm_ca, lm_cb, lm_cc, lm_cd,
                                             lm_count, z, z_valid, noisy_rot,
                                             noisy_trans, config)
    planes = (lm_mx, lm_my, lm_ca, lm_cb, lm_cc if config.parity_mode else None, lm_cd)
    _check_multi_inputs(poses, log_weights, planes, lm_count, z, z_valid,
                        noisy_rot, noisy_trans, config)
    device = require_cuda(poses, log_weights, *planes, lm_count, noisy_rot, noisy_trans)
    l, p = lm_mx.shape
    c, m = z.shape[0], z.shape[1]
    tile, lanes = motion_launch_geometry(l, m, config.parity_mode)
    z4, zvalid, mlast = _measurement_table(z, z_valid)
    cyaw = torch.cos(poses[:, 2]).contiguous()
    syaw = torch.sin(poses[:, 2]).contiguous()
    traj = torch.empty((4, c, p), dtype=torch.float32, device=device)
    cc = lm_cc if config.parity_mode else lm_cb
    # the kernel takes cos/sin of noisy_rot itself (cosf/sinf, equal to
    # torch.cos/torch.sin on the card bit for bit)
    launch(
        "fused_update_planes_multi", device,
        ptr(poses), ptr(cyaw), ptr(syaw), ptr(log_weights),
        ptr(noisy_rot), ptr(noisy_trans),
        ptr(lm_mx), ptr(lm_my), ptr(lm_ca), ptr(lm_cb), ptr(cc), ptr(lm_cd),
        ptr(lm_count), ptr(z4), ptr(zvalid), ptr(mlast),
        ptr(traj[0]), ptr(traj[1]), ptr(traj[2]), ptr(traj[3]),
        ctypes.c_int(p), ctypes.c_int(l), ctypes.c_int(m), ctypes.c_int(c),
        ctypes.c_int(int(config.parity_mode)), *_gate_args(config),
        ctypes.c_int(tile), ctypes.c_int(lanes),
    )
    return (traj[0], traj[1], traj[2], traj[3], lm_mx, lm_my, lm_ca, lm_cb,
            lm_cc if config.parity_mode else None, lm_cd, lm_count)


def fused_fs2_planes(pred_poses, log_weights, lm_mx, lm_my, lm_ca, lm_cb, lm_cc,
                     lm_cd, lm_count, z, z_valid, noise, s_t2, s_r2, fxy,
                     config: FastSLAMConfig, *, evidence_scale=None):
    """One FastSLAM 2.0 tick for all particles (production mode).

    Args:
      pred_poses ``[P, 3]``: the mean-motion predicted poses; log_weights
      ``[P]``; landmark planes ``[L, P]`` (``lm_cc`` is ignored: the
      production covariance is symmetric); lm_count ``[P]`` int32; z
      ``[M, 2]``, z_valid ``[M]``; noise ``[P, 3]`` standard normals of the
      pose sample; ``s_t2``, ``s_r2``, ``fxy``: the tick's prior variances
      (``kernels.fs2_prior_scalars``); ``evidence_scale``: the mode dial in
      [0, 1], ``None`` meaning 1.

    Returns ``(poses [P, 3], log_weights, mx, my, ca, cb, None, cd,
    lm_count)``: new sampled poses, and the input tensors updated in place.
    """
    if pred_poses.device.type == "cpu":
        return fused_fs2_planes_ref(pred_poses, log_weights, lm_mx, lm_my, lm_ca,
                                    lm_cb, lm_cc, lm_cd, lm_count, z, z_valid,
                                    noise, s_t2, s_r2, fxy, config,
                                    evidence_scale=evidence_scale)
    planes = (lm_mx, lm_my, lm_ca, lm_cb, None, lm_cd)
    _check_fs2_inputs(pred_poses, log_weights, planes, lm_count, z, z_valid,
                      config)
    device = require_cuda(pred_poses, log_weights, *planes, lm_count, noise)
    if z.dim() != 2:
        raise ValueError(f"measurements must be [M, 2], got {tuple(z.shape)}")
    l, p = lm_mx.shape
    _check_noise(noise, (p, 3), device)
    m = z.shape[0]
    tile, lanes = fs2_launch_geometry(l, m)
    z4, zvalid, mlast = _measurement_table(z, z_valid)
    prior = _prior_table(s_t2, s_r2, fxy, evidence_scale, None, device)
    cyaw = torch.cos(pred_poses[:, 2]).contiguous()
    syaw = torch.sin(pred_poses[:, 2]).contiguous()
    poses = torch.empty((p, 3), dtype=torch.float32, device=device)
    launch(
        "fused_fs2_planes", device,
        ptr(pred_poses), ptr(cyaw), ptr(syaw), ptr(log_weights), ptr(noise),
        ptr(poses), ptr(lm_mx), ptr(lm_my), ptr(lm_ca), ptr(lm_cb),
        ptr(lm_cd), ptr(lm_count), ptr(z4), ptr(zvalid), ptr(mlast),
        ptr(prior), ctypes.c_int(p), ctypes.c_int(l), ctypes.c_int(m),
        ctypes.c_int(int(config.fs2_evidence_weights)), *_gate_args(config),
        ctypes.c_int(tile), ctypes.c_int(lanes),
    )
    return (poses, log_weights, lm_mx, lm_my, lm_ca, lm_cb, None, lm_cd, lm_count)


def fused_fs2_planes_multi(poses, log_weights, lm_mx, lm_my, lm_ca, lm_cb,
                           lm_cc, lm_cd, lm_count, z, z_valid, noise, rot_eff,
                           trans_eff, s_t2, s_r2, fxy, config: FastSLAMConfig,
                           *, evidence_scale=None) -> Tuple[torch.Tensor, ...]:
    """C FastSLAM 2.0 ticks in one call (production mode).

    Each tick predicts the mean motion in-kernel (``rot_eff``/``trans_eff``
    ``[C]``, 0 on the inactive component), accumulates the proposal at the
    predicted pose, samples with ``noise`` ``[C, 3, P]`` and runs the
    landmark EKF at the sampled pose; the planes carry across ticks.
    ``s_t2``/``s_r2`` are ``[C]``; ``fxy`` and ``evidence_scale`` a scalar or
    ``[C]``.  ``poses`` and ``log_weights`` are read only.

    Returns ``(tx, ty, tyaw, tlogw [C, P], mx, my, ca, cb, None, cd,
    lm_count)``: per-tick trajectories and the input planes and counts,
    updated in place.
    """
    if poses.device.type == "cpu":
        return fused_fs2_planes_multi_ref(poses, log_weights, lm_mx, lm_my, lm_ca,
                                          lm_cb, lm_cc, lm_cd, lm_count, z,
                                          z_valid, noise, rot_eff, trans_eff,
                                          s_t2, s_r2, fxy, config,
                                          evidence_scale=evidence_scale)
    planes = (lm_mx, lm_my, lm_ca, lm_cb, None, lm_cd)
    _check_fs2_inputs(poses, log_weights, planes, lm_count, z, z_valid, config)
    device = require_cuda(poses, log_weights, *planes, lm_count, noise)
    if z.dim() != 3:
        raise ValueError(f"chunked measurements must be [C, M, 2], got {tuple(z.shape)}")
    l, p = lm_mx.shape
    c, m = z.shape[0], z.shape[1]
    _check_noise(noise, (c, 3, p), device)
    tile, lanes = fs2_launch_geometry(l, m)
    z4, zvalid, mlast = _measurement_table(z, z_valid)
    motion = _motion_table(rot_eff, trans_eff, c, device)
    prior = _prior_table(s_t2, s_r2, fxy, evidence_scale, c, device)
    cyaw = torch.cos(poses[:, 2]).contiguous()
    syaw = torch.sin(poses[:, 2]).contiguous()
    traj = torch.empty((4, c, p), dtype=torch.float32, device=device)
    launch(
        "fused_fs2_planes_multi", device,
        ptr(poses), ptr(cyaw), ptr(syaw), ptr(log_weights), ptr(noise),
        ptr(motion), ptr(prior), ptr(lm_mx), ptr(lm_my), ptr(lm_ca),
        ptr(lm_cb), ptr(lm_cd), ptr(lm_count), ptr(z4), ptr(zvalid),
        ptr(mlast), ptr(traj[0]), ptr(traj[1]), ptr(traj[2]), ptr(traj[3]),
        ctypes.c_int(p), ctypes.c_int(l), ctypes.c_int(m), ctypes.c_int(c),
        ctypes.c_int(int(config.fs2_evidence_weights)), *_gate_args(config),
        ctypes.c_int(tile), ctypes.c_int(lanes),
    )
    return (traj[0], traj[1], traj[2], traj[3], lm_mx, lm_my, lm_ca, lm_cb, None,
            lm_cd, lm_count)
