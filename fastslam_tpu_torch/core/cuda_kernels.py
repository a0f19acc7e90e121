"""The fused measurement-update kernels and their plain PyTorch versions.

Counterpart of ``fastslam_tpu/core/pallas_kernels.py``:

* the motion proposal: one tick (:func:`fused_update_planes`) or C ticks
  with in-kernel propagation (:func:`fused_update_planes_multi`) of
  association, 2x2 landmark EKF, append and weight update for every
  particle (``csrc/fused_update.cu``);
* the FastSLAM 2.0 proposal: one tick (:func:`fused_fs2_planes`) or C ticks
  with in-kernel mean-motion prediction (:func:`fused_fs2_planes_multi`) of
  proposal accumulation at the predicted pose, pose solve and sample, and
  the landmark EKF at the sampled pose (``csrc/fused_fs2.cu``);
* the nearest-neighbour step of ICP (:func:`icp_correspondences`,
  ``csrc/icp_nn.cu``): for each source point of a batch of cloud pairs, the
  closest valid target point; and the whole point-to-line ICP loop around
  it, every iteration of every pair in one launch
  (:func:`icp_point_to_line_fused`, same file);
* the ring halo exchange of the distributed resampler
  (:func:`ring_halo_exchange`, ``csrc/ring_halo.cu``): every shard's packed
  particle block to both ring neighbours, for a ring of shards on one card;
* the ceiling probes of the card (``csrc/probes.cu``), which the probe
  entry points of :mod:`fastslam_tpu_torch.probes` time: the device-memory
  copy over the fused update's buffer set (:func:`hbm_copy`), the
  shared-memory stream (:func:`mul_add`) and the FP32 FMA rate
  (:func:`fma_chain`).

:func:`fused_update` is the blocks-layout (``[P, L, k]``) entry of the
per-tick motion kernel: it transposes to planes and back, as the JAX
package's wrapper of the same name does.

The four filter kernels stage a tile of particles' planes in shared memory
for the tick (the per-tick kernels) or the chunk (the chunked ones), with a
few lanes per particle (:func:`fs2_launch_geometry`,
:func:`motion_launch_geometry`; ``csrc/tile.cuh``), and share their
per-measurement device code (``csrc/measurement.cuh``).  The ICP search
splits each source point's scan over a few lanes; the fused point-to-line
kernel runs one block per cloud pair (:func:`icp_fused_layout`); the
exchange kernel one thread per 16 bytes.
``core/_build.py`` compiles and loads them.

Each wrapper dispatches on the device of the tensors it is given:

* CUDA tensors launch the kernel, or raise.  There is no fallback.
* CPU tensors run the plain version (``*_ref``), which mirrors the kernel
  operation for operation on ``[L, P]`` tensors.

The four filter kernels update the landmark planes and ``lm_count`` in
place (each particle owns its column, so a kernel needs no second buffer);
the per-tick wrappers also update ``log_weights`` in place.  Callers that need the inputs
afterwards pass clones.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that it
went through the kernels; the plain versions never touch it.
"""

from __future__ import annotations

import ctypes
import math
import struct
from typing import Optional, Tuple

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core.state import FilterState, from_planes, to_planes

LAUNCHES = {"fused_update_planes": 0, "fused_update_planes_multi": 0,
            "fused_fs2_planes": 0, "fused_fs2_planes_multi": 0,
            "icp_correspondences": 0, "icp_point_to_line": 0, "icp_sin_cos": 0,
            "ring_halo_exchange": 0, "hbm_copy": 0, "mul_add": 0, "fma_chain": 0}

_LOG_TWO_PI = math.log(2.0 * math.pi)
_PI = math.pi

# packed-argmin sentinel: +inf bits with all slot bits set, larger than any
# usable (finite, non-negative) distance key
_INVALID_KEY = 0x7F8000FF

# the most shared memory any kernel declares statically (trip count, rows,
# motion and prior rows)
_STATIC_SMEM_BYTES = 64
# the most shards one exchange launch takes (csrc/ring_halo.cu RING_MAX_SHARDS)
RING_MAX_SHARDS = 64
# the copy probe's buffers (six [L, P] planes and one [1, P] row) and the
# floats one of its blocks moves per buffer (256 threads x float4)
HBM_COPY_BUFFERS = 7
HBM_COPY_TILE = 1024
# shared memory a block may opt into (csrc/probes.cu SMEM_OPT_IN_LIMIT)
SMEM_OPT_IN_BYTES = 232_448
# the fs2 kernels' launch geometry: particles per block (the tile staged in
# shared memory) and lanes per particle, chosen by timing the candidates at
# P = 100,000, L = 64, M = 16 (chip_smoke.py phase 9, PERF.md §6)
FS2_TILE, FS2_LANES = 32, 4
# the motion kernels' launch geometry (per tick and chunked), timed the same
# way (phase 9)
MOTION_TILE, MOTION_LANES = 32, 4
# the fused point-to-line ICP kernel: threads per cloud pair and lanes per
# source point, the fastest of seven at both the online (2 pairs) and the
# replay (597 pairs) batch (phase 9, PERF.md §6); then the targets staged
# per shared-memory tile, the eleven sums, and the bytes up to which the
# per-point arrays (sums [11, P2], moved source [N, 2]) stay in shared
# memory, past which they go to device-memory scratch (csrc/icp_nn.cu:
# TGT_TILE, kSums, kPointSmemBytes)
ICP_THREADS, ICP_LANES = 512, 8
ICP_TGT_TILE = 1024
ICP_SUMS = 11
ICP_POINT_SMEM_BYTES = 65536
# the fma_chain probe's constants: x <- fma(x, a, b), 8 per pass
FMA_CHAIN_A = 1.0000001
FMA_CHAIN_B = 1e-7
MUL_ADD_DECAY = 0.9999


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


# ---------------------------------------------------------------------------
# plain version: ICP nearest neighbours
# ---------------------------------------------------------------------------

def icp_correspondences_ref(source, target, target_valid):
    """Plain PyTorch version of :func:`icp_correspondences` (same contract):
    the dense ``[..., N, Mt]`` squared distances, ``inf`` on invalid
    targets, the first index at the minimum and the square root of it."""
    _check_nn_inputs(source, target, target_valid)
    diff = source[..., :, None, :] - target[..., None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(target_valid[..., None, :], d2, torch.inf)
    idx = torch.argmin(d2, dim=-1, keepdim=True)   # first of equal minima
    dist = torch.sqrt(torch.gather(d2, -1, idx))[..., 0]
    return dist, idx[..., 0].to(torch.int32)


def _rotate(x, y, c, s):
    """``R(theta) (x, y)`` elementwise, as ``proposal/icp.py:rotate_points``."""
    return c * x - s * y, s * x + c * y


def icp_point_to_line_ref(source, target, source_valid, target_valid, normals,
                          normal_valid, max_iter: int, tol: float):
    """Plain PyTorch version of :func:`icp_point_to_line_fused` (same
    contract): the batched while-loop of point-to-line ICP, each pair frozen
    once it converges, its sums by :func:`~fastslam_tpu_torch.core.kernels.tree_sum`
    in the kernel's order.  The host checks every iteration whether a pair is
    still active (on the CPU that costs nothing)."""
    from fastslam_tpu_torch.core.kernels import tree_sum

    _check_icp_fused_inputs(source, target, source_valid, target_valid, normals,
                            normal_valid, max_iter)
    b = source.shape[0]
    dev, dt = source.device, source.dtype
    sw = source_valid.to(dt)
    # the normal and its validity gathered together: [B, Mt, 3]
    nq = torch.cat([normals, normal_valid.to(dt)[..., None]], dim=-1)
    gather = lambda pts, idx: torch.gather(
        pts, 1, idx.long()[..., None].expand(*idx.shape, pts.shape[-1]))
    src = source
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    theta_total = torch.zeros(b, dtype=dt, device=dev)
    trans_total = torch.zeros((b, 2), dtype=dt, device=dev)
    prev_err = torch.full((b,), torch.inf, dtype=dt, device=dev)
    converged = torch.zeros(b, dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        if bool(converged.all()):
            break
        active = ~converged
        dist, idx = icp_correspondences_ref(src, target, target_valid)
        q = gather(target, idx)
        ng = gather(nq, idx)
        nx, ny = ng[..., 0], ng[..., 1]
        w = sw * ng[..., 2]
        sx, sy = src[..., 0], src[..., 1]
        r = (sx - q[..., 0]) * nx + (sy - q[..., 1]) * ny
        j0 = sx * ny - sy * nx           # J = [cross(s, n), n_x, n_y]
        wj0, wj1, wj2 = w * j0, w * nx, w * ny
        sums = tree_sum(torch.stack([wj0 * j0, wj0 * nx, wj0 * ny, wj1 * nx, wj1 * ny,
                                     wj2 * ny, wj0 * r, wj1 * r, wj2 * r, dist * w, w],
                                    dim=1))
        h00 = sums[:, 0] + 1e-9
        h01 = sums[:, 1]
        h02 = sums[:, 2]
        h11 = sums[:, 3] + 1e-9
        h12 = sums[:, 4]
        h22 = sums[:, 5] + 1e-9
        b0, b1, b2 = -sums[:, 6], -sums[:, 7], -sums[:, 8]
        # 3x3 symmetric solve via cofactors
        c00 = h11 * h22 - h12 * h12
        c01 = h02 * h12 - h01 * h22
        c02 = h01 * h12 - h02 * h11
        det = h00 * c00 + h01 * c01 + h02 * c02
        det = torch.where(torch.abs(det) > 1e-12, det, 1e-12)
        c11 = h00 * h22 - h02 * h02
        c12 = h01 * h02 - h00 * h12
        c22 = h00 * h11 - h01 * h01
        theta = (c00 * b0 + c01 * b1 + c02 * b2) / det
        tx = (c01 * b0 + c11 * b1 + c12 * b2) / det
        ty = (c02 * b0 + c12 * b1 + c22 * b2) / det
        err = sums[:, 9] / torch.clamp_min(sums[:, 10], 1e-12)

        c, s = torch.cos(theta), torch.sin(theta)
        x, y = _rotate(sx, sy, c[:, None], s[:, None])
        new_src = torch.stack([x + tx[:, None], y + ty[:, None]], dim=-1)
        x, y = _rotate(trans_total[:, 0], trans_total[:, 1], c, s)
        new_trans_total = torch.stack([x + tx, y + ty], dim=-1)
        src = torch.where(active[:, None, None], new_src, src)
        trans_total = torch.where(active[:, None], new_trans_total, trans_total)
        theta_total = torch.where(active, theta_total + theta, theta_total)
        conv = torch.abs(prev_err - err) < tol
        prev_err = torch.where(active, err, prev_err)
        converged = torch.where(active, conv, converged)
        it = it + active.to(torch.int32)
    return theta_total, trans_total, prev_err, it


def icp_rotation_sin_cos_ref(x):
    """Plain PyTorch version of :func:`icp_rotation_sin_cos`."""
    _check_sin_cos(x)
    return torch.sin(x), torch.cos(x)


# ---------------------------------------------------------------------------
# plain version: the ring halo exchange
# ---------------------------------------------------------------------------

def ring_halo_exchange_ref(blocks):
    """Plain PyTorch version of :func:`ring_halo_exchange` (same contract):
    a copy of each neighbour's block, shard by shard."""
    _check_ring_blocks(blocks)
    s = len(blocks)
    lefts = [blocks[(i - 1) % s].clone() for i in range(s)]
    rights = [blocks[(i + 1) % s].clone() for i in range(s)]
    return lefts, rights


# ---------------------------------------------------------------------------
# plain versions: the ceiling probes
# ---------------------------------------------------------------------------

def hbm_copy_ref(buffers):
    """Plain PyTorch version of :func:`hbm_copy` (same contract): ``x + 1``
    per buffer."""
    buffers = list(buffers)
    _check_copy_buffers(buffers)
    return [torch.add(x, 1.0) for x in buffers]


def mul_add_ref(a, b, c, passes: int = 256, tile: int = 256):
    """Plain PyTorch version of :func:`mul_add` (same contract): ``passes``
    times ``c = a * b + c * 0.9999`` in float32 eager ops, in the kernel's
    order (two multiplies, then the add).  ``tile`` shapes only the
    kernel's blocks."""
    _check_mul_add(a, b, c, passes, tile)
    out = c.clone()
    for _ in range(passes):
        out = a * b + out * MUL_ADD_DECAY
    return out


def _f32_value(x: float) -> float:
    """The float32 nearest ``x``, as a Python float."""
    return struct.unpack("<f", struct.pack("<f", x))[0]


def fma_chain_ref(x, passes: int = 256):
    """Plain PyTorch version of :func:`fma_chain` (same contract): each of
    the ``8 * passes`` steps ``x * a + b`` in float64 with the float32
    values of the constants, rounded to float32.  The product is exact in
    float64, so a step equals the kernel's fused multiply-add except where
    the sum's two roundings (to float64, then float32) differ from one:
    rarely, and by one float32 ulp."""
    _check_fma_chain(x, passes)
    a, b = _f32_value(FMA_CHAIN_A), _f32_value(FMA_CHAIN_B)
    out = x.clone()
    for _ in range(8 * passes):
        out = (out.double() * a + b).float()
    return out


# ---------------------------------------------------------------------------
# checks and launch parameters
# ---------------------------------------------------------------------------

def _check_copy_buffers(buffers):
    if len(buffers) != HBM_COPY_BUFFERS or buffers[0].dim() != 2:
        raise ValueError(f"the copy takes {HBM_COPY_BUFFERS} buffers: six [L, P] "
                         "planes and one [1, P] row")
    l, p = buffers[0].shape
    device = buffers[0].device
    for i, t in enumerate(buffers):
        shape = (l, p) if i + 1 < HBM_COPY_BUFFERS else (1, p)
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"copy buffer {i} must be float32 {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_mul_add(a, b, c, passes: int, tile: int):
    if a.dim() != 2:
        raise ValueError(f"mul_add takes [L, P] planes, got {tuple(a.shape)}")
    for t in (a, b, c):
        if t.shape != a.shape or t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"a, b and c must be float32 {tuple(a.shape)} on {a.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    l = a.shape[0]
    if passes < 0 or tile < 1 or 3 * l * tile * 4 > SMEM_OPT_IN_BYTES:
        raise ValueError(f"mul_add needs passes >= 0 and 3 * L * tile * 4 <= "
                         f"{SMEM_OPT_IN_BYTES} bytes of shared memory, got passes "
                         f"{passes}, L {l}, tile {tile}")


def _check_fma_chain(x, passes: int):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"fma_chain takes a float32 [L, P] plane, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if passes < 0:
        raise ValueError(f"passes must be >= 0, got {passes}")

def _check_nn_inputs(source, target, target_valid):
    if source.dim() not in (2, 3) or source.shape[-1] != 2:
        raise ValueError(f"source must be [N, 2] or [B, N, 2], got {tuple(source.shape)}")
    batch = tuple(source.shape[:-2])
    if target.dim() != source.dim() or target.shape[-1] != 2 \
            or tuple(target.shape[:-2]) != batch:
        raise ValueError(f"target must be [{', '.join(map(str, batch + ('Mt', 2)))}], "
                         f"got {tuple(target.shape)}")
    if tuple(target_valid.shape) != tuple(target.shape[:-1]) \
            or target_valid.dtype != torch.bool:
        raise ValueError("target_valid must be bool of the target's leading shape")
    device = source.device
    for t in (source, target):
        if t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"source and target must be float32 on {device}, "
                             f"got {t.dtype} on {t.device}")
    if target_valid.device != device:
        raise ValueError(f"target_valid must lie on {device}")


def _check_icp_fused_inputs(source, target, source_valid, target_valid, normals,
                            normal_valid, max_iter):
    if source.dim() != 3 or source.shape[-1] != 2 or source.shape[1] < 1:
        raise ValueError(f"source must be [B, N, 2] with N >= 1, got {tuple(source.shape)}")
    b, n = source.shape[:2]
    if target.dim() != 3 or target.shape[0] != b or target.shape[-1] != 2 \
            or target.shape[1] < 1:
        raise ValueError(f"target must be [{b}, Mt, 2] with Mt >= 1, got "
                         f"{tuple(target.shape)}")
    mt = target.shape[1]
    device = source.device
    for name, t, shape, dtype in (
            ("target", target, (b, mt, 2), torch.float32),
            ("normals", normals, (b, mt, 2), torch.float32),
            ("source_valid", source_valid, (b, n), torch.bool),
            ("target_valid", target_valid, (b, mt), torch.bool),
            ("normal_valid", normal_valid, (b, mt), torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
            raise ValueError(f"{name} must be {dtype} {shape} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if source.dtype != torch.float32:
        raise ValueError(f"source must be float32, got {source.dtype}")
    if int(max_iter) < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")


def _check_sin_cos(x):
    if x.dtype != torch.float32 or x.dim() != 1 or x.numel() >= 2 ** 31:
        raise ValueError(f"the rotation check takes a float32 vector of fewer than 2^31 "
                         f"values, got {x.dtype} {tuple(x.shape)}")


def _check_ring_blocks(blocks):
    if not blocks or blocks[0].dim() != 2:
        raise ValueError("a ring needs at least one [P_local, D] block")
    first = blocks[0]
    for b in blocks:
        if (b.shape != first.shape or b.dtype != torch.float32
                or b.device != first.device):
            raise ValueError(f"ring blocks must be float32 {tuple(first.shape)} on "
                             f"{first.device}, got {b.dtype} {tuple(b.shape)} on {b.device}")


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


def icp_fused_layout(n: int, mt: int) -> Tuple[int, int, bool]:
    """``(p2, smem, in_scratch)`` of the fused point-to-line kernel for N
    source and Mt target points: the least power of two ``p2 >= N`` that the
    sums' tree pads the point axis to, the block's dynamic shared memory (a
    tile of up to ``ICP_TGT_TILE`` targets with normals and flags, 20 bytes
    each, and the per-point arrays unless they go to scratch), and whether
    the per-point arrays (``[11, p2]`` terms and the ``[N, 2]`` moved
    source) go to a device-memory scratch row of each pair
    (``csrc/icp_nn.cu``: ``icp_fused_shared_bytes``)."""
    p2 = 1 << max(n - 1, 0).bit_length()
    points = 4 * (ICP_SUMS * p2 + 2 * n)
    in_scratch = points > ICP_POINT_SMEM_BYTES
    return p2, 20 * min(mt, ICP_TGT_TILE) + (0 if in_scratch else points), in_scratch


def _gate_args(config: FastSLAMConfig):
    gate = float(config.max_landmark_distance)
    dc = float(config.default_landmark_cov)
    gate_thr = ((_f32_bits(gate * gate) - 1) & ~0xFF) | 0xFF
    return (ctypes.c_float(gate * gate), ctypes.c_int(gate_thr),
            ctypes.c_float(config.measurement_noise), ctypes.c_float(dc),
            ctypes.c_float(dc * dc))


def _require_cuda(*tensors):
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return device


def _launch(fn, device: torch.device, *args):
    from fastslam_tpu_torch.core import _build

    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(ctypes.c_int(device.index if device.index is not None
                         else torch.cuda.current_device()),
            *args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"CUDA kernel launch failed: {_build.error_string(rc)}")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

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
    device = _require_cuda(poses, log_weights, *planes, lm_count)
    if z.dim() != 2:
        raise ValueError(f"measurements must be [M, 2], got {tuple(z.shape)}")
    from fastslam_tpu_torch.core import _build

    l, p = lm_mx.shape
    m = z.shape[0]
    tile, lanes = motion_launch_geometry(l, m, config.parity_mode)
    z4, zvalid, mlast = _measurement_table(z, z_valid)
    cyaw = torch.cos(poses[:, 2]).contiguous()
    syaw = torch.sin(poses[:, 2]).contiguous()
    cc = lm_cc if config.parity_mode else lm_cb
    _launch(
        _build.load().fused_update_planes_launch, device,
        _ptr(poses), _ptr(cyaw), _ptr(syaw), _ptr(log_weights),
        _ptr(lm_mx), _ptr(lm_my), _ptr(lm_ca), _ptr(lm_cb), _ptr(cc), _ptr(lm_cd),
        _ptr(lm_count), _ptr(z4), _ptr(zvalid), _ptr(mlast),
        ctypes.c_int(p), ctypes.c_int(l), ctypes.c_int(m),
        ctypes.c_int(int(config.parity_mode)), *_gate_args(config),
        ctypes.c_int(tile), ctypes.c_int(lanes),
    )
    LAUNCHES["fused_update_planes"] += 1
    return (log_weights, lm_mx, lm_my, lm_ca, lm_cb,
            lm_cc if config.parity_mode else None, lm_cd, lm_count)


def fused_update(poses, log_weights, lm_mean, lm_cov, lm_count, z, z_valid,
                 config: FastSLAMConfig):
    """One tick of measurement updates on the blocks layout: lm_mean
    ``[P, L, 2]``, lm_cov ``[P, L, 4]`` are transposed to ``[L, P]`` planes
    for :func:`fused_update_planes` and back (``state.to_planes``,
    ``from_planes``), with no padding.  On CUDA tensors that launches the
    per-tick kernel; on the CPU it runs the kernel's plain version.  In
    production the kernel keeps no ``cc`` plane and ``cov[..., 2]`` comes
    back equal to ``cov[..., 1]``.

    Returns new ``(log_weights, lm_mean, lm_cov, lm_count)``; the inputs are
    not changed.
    """
    planes = to_planes(FilterState(poses, log_weights, lm_mean, lm_cov, lm_count), config)
    logw, mx, my, ca, cb, cc, cd, cnt = fused_update_planes(
        planes.poses, planes.log_weights, planes.lm_mx, planes.lm_my, planes.lm_ca,
        planes.lm_cb, planes.lm_cc, planes.lm_cd, planes.lm_count, z, z_valid, config)
    new = from_planes(planes.replace(log_weights=logw, lm_mx=mx, lm_my=my, lm_ca=ca,
                                     lm_cb=cb, lm_cc=cc, lm_cd=cd, lm_count=cnt))
    return new.log_weights, new.lm_mean, new.lm_cov, new.lm_count


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
    device = _require_cuda(poses, log_weights, *planes, lm_count, noisy_rot,
                           noisy_trans)
    from fastslam_tpu_torch.core import _build

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
    _launch(
        _build.load().fused_update_planes_multi_launch, device,
        _ptr(poses), _ptr(cyaw), _ptr(syaw), _ptr(log_weights),
        _ptr(noisy_rot), _ptr(noisy_trans),
        _ptr(lm_mx), _ptr(lm_my), _ptr(lm_ca), _ptr(lm_cb), _ptr(cc), _ptr(lm_cd),
        _ptr(lm_count), _ptr(z4), _ptr(zvalid), _ptr(mlast),
        _ptr(traj[0]), _ptr(traj[1]), _ptr(traj[2]), _ptr(traj[3]),
        ctypes.c_int(p), ctypes.c_int(l), ctypes.c_int(m), ctypes.c_int(c),
        ctypes.c_int(int(config.parity_mode)), *_gate_args(config),
        ctypes.c_int(tile), ctypes.c_int(lanes),
    )
    LAUNCHES["fused_update_planes_multi"] += 1
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
    device = _require_cuda(pred_poses, log_weights, *planes, lm_count, noise)
    if z.dim() != 2:
        raise ValueError(f"measurements must be [M, 2], got {tuple(z.shape)}")
    l, p = lm_mx.shape
    _check_noise(noise, (p, 3), device)
    from fastslam_tpu_torch.core import _build

    m = z.shape[0]
    tile, lanes = fs2_launch_geometry(l, m)
    z4, zvalid, mlast = _measurement_table(z, z_valid)
    prior = _prior_table(s_t2, s_r2, fxy, evidence_scale, None, device)
    cyaw = torch.cos(pred_poses[:, 2]).contiguous()
    syaw = torch.sin(pred_poses[:, 2]).contiguous()
    poses = torch.empty((p, 3), dtype=torch.float32, device=device)
    _launch(
        _build.load().fused_fs2_planes_launch, device,
        _ptr(pred_poses), _ptr(cyaw), _ptr(syaw), _ptr(log_weights), _ptr(noise),
        _ptr(poses), _ptr(lm_mx), _ptr(lm_my), _ptr(lm_ca), _ptr(lm_cb),
        _ptr(lm_cd), _ptr(lm_count), _ptr(z4), _ptr(zvalid), _ptr(mlast),
        _ptr(prior), ctypes.c_int(p), ctypes.c_int(l), ctypes.c_int(m),
        ctypes.c_int(int(config.fs2_evidence_weights)), *_gate_args(config),
        ctypes.c_int(tile), ctypes.c_int(lanes),
    )
    LAUNCHES["fused_fs2_planes"] += 1
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
    device = _require_cuda(poses, log_weights, *planes, lm_count, noise)
    if z.dim() != 3:
        raise ValueError(f"chunked measurements must be [C, M, 2], got {tuple(z.shape)}")
    l, p = lm_mx.shape
    c, m = z.shape[0], z.shape[1]
    _check_noise(noise, (c, 3, p), device)
    from fastslam_tpu_torch.core import _build

    tile, lanes = fs2_launch_geometry(l, m)
    z4, zvalid, mlast = _measurement_table(z, z_valid)
    motion = _motion_table(rot_eff, trans_eff, c, device)
    prior = _prior_table(s_t2, s_r2, fxy, evidence_scale, c, device)
    cyaw = torch.cos(poses[:, 2]).contiguous()
    syaw = torch.sin(poses[:, 2]).contiguous()
    traj = torch.empty((4, c, p), dtype=torch.float32, device=device)
    _launch(
        _build.load().fused_fs2_planes_multi_launch, device,
        _ptr(poses), _ptr(cyaw), _ptr(syaw), _ptr(log_weights), _ptr(noise),
        _ptr(motion), _ptr(prior), _ptr(lm_mx), _ptr(lm_my), _ptr(lm_ca),
        _ptr(lm_cb), _ptr(lm_cd), _ptr(lm_count), _ptr(z4), _ptr(zvalid),
        _ptr(mlast), _ptr(traj[0]), _ptr(traj[1]), _ptr(traj[2]), _ptr(traj[3]),
        ctypes.c_int(p), ctypes.c_int(l), ctypes.c_int(m), ctypes.c_int(c),
        ctypes.c_int(int(config.fs2_evidence_weights)), *_gate_args(config),
        ctypes.c_int(tile), ctypes.c_int(lanes),
    )
    LAUNCHES["fused_fs2_planes_multi"] += 1
    return (traj[0], traj[1], traj[2], traj[3], lm_mx, lm_my, lm_ca, lm_cb, None,
            lm_cd, lm_count)


def icp_correspondences(source, target, target_valid):
    """Nearest valid target point of every source point (ICP correspondences).

    Args:
      source ``[N, 2]`` or ``[B, N, 2]`` float32; target ``[Mt, 2]`` or
      ``[B, Mt, 2]`` float32; target_valid ``[Mt]`` or ``[B, Mt]`` bool.  With
      a leading batch axis each source cloud is matched against the target
      cloud of the same pair.

    Returns ``(dist, idx)``, each ``[N]`` or ``[B, N]``: the Euclidean
    distance (float32) and index (int32) of the closest valid target; the
    first index on ties; ``(inf, 0)`` when no target is valid.
    """
    if source.device.type == "cpu":
        return icp_correspondences_ref(source, target, target_valid)
    _check_nn_inputs(source, target, target_valid)
    device = _require_cuda(source, target, target_valid)
    from fastslam_tpu_torch.core import _build

    n, mt = source.shape[-2], target.shape[-2]
    b = source.shape[0] if source.dim() == 3 else 1
    batch = tuple(source.shape[:-2])
    dist = torch.empty(batch + (n,), dtype=torch.float32, device=device)
    idx = torch.empty(batch + (n,), dtype=torch.int32, device=device)
    _launch(
        _build.load().icp_correspondences_launch, device,
        _ptr(source), _ptr(target), _ptr(target_valid), _ptr(dist), _ptr(idx),
        ctypes.c_int(b), ctypes.c_int(n), ctypes.c_int(mt),
    )
    LAUNCHES["icp_correspondences"] += 1
    return dist, idx


def ring_halo_exchange(blocks):
    """Every shard's block to both ring neighbours, for a ring of shards on
    one card, in one launch.

    Args:
      blocks: S float32 ``[P_local, D]`` blocks, one per shard in ring order,
      contiguous and on one device (``D = 3 + 1 + 2L + 4L + 1`` for the packed
      particle block of ``parallel/resample.py:pack_particle_block``).

    Returns ``(lefts, rights)``: lists of S new blocks, ``lefts[s]`` the
    block of shard ``s - 1`` and ``rights[s]`` that of shard ``s + 1``
    (mod S).  At S = 1 both are copies of the one block.
    """
    blocks = list(blocks)
    if blocks and blocks[0].device.type == "cpu":
        return ring_halo_exchange_ref(blocks)
    _check_ring_blocks(blocks)
    device = _require_cuda(*blocks)
    s, n = len(blocks), blocks[0].numel()
    if s > RING_MAX_SHARDS:
        raise ValueError(f"one exchange takes at most {RING_MAX_SHARDS} shards, got {s}")
    if n >= 2 ** 31:
        raise ValueError(f"a block of {n} floats is too large for one exchange")
    if any(b.data_ptr() % 16 for b in blocks):
        raise ValueError("the exchange kernel takes blocks aligned to 16 bytes")
    from fastslam_tpu_torch.core import _build

    lefts = [torch.empty_like(b) for b in blocks]
    rights = [torch.empty_like(b) for b in blocks]
    pointers = lambda ts: (ctypes.c_void_p * s)(*(t.data_ptr() for t in ts))
    src, left, right = pointers(blocks), pointers(lefts), pointers(rights)
    _launch(
        _build.load().ring_halo_exchange_launch, device,
        *(ctypes.c_void_p(ctypes.addressof(a)) for a in (src, left, right)),
        ctypes.c_int(s), ctypes.c_int(n),
    )
    LAUNCHES["ring_halo_exchange"] += 1
    return lefts, rights


def _check_launch_size(tensors):
    if any(t.numel() >= 2 ** 31 for t in tensors):
        raise ValueError("a probe buffer of 2^31 floats or more is too large for one launch")


def hbm_copy(buffers):
    """The copy probe: ``x + 1`` for each of seven buffers, in one launch.

    Args:
      buffers: six float32 ``[L, P]`` planes and one ``[1, P]`` row (the
      fused update's buffer set), contiguous, aligned to 16 bytes, on one
      device.

    Returns a list of seven new tensors, ``buffers[i] + 1``.
    """
    buffers = list(buffers)
    if buffers and buffers[0].device.type == "cpu":
        return hbm_copy_ref(buffers)
    _check_copy_buffers(buffers)
    device = _require_cuda(*buffers)
    _check_launch_size(buffers)
    if any(b.data_ptr() % 16 for b in buffers):
        raise ValueError("the copy kernel takes buffers aligned to 16 bytes")
    from fastslam_tpu_torch.core import _build

    outs = [torch.empty_like(b) for b in buffers]
    pointers = lambda ts: (ctypes.c_void_p * HBM_COPY_BUFFERS)(*(t.data_ptr() for t in ts))
    src, dst = pointers(buffers), pointers(outs)
    _launch(
        _build.load().hbm_copy_launch, device,
        ctypes.c_void_p(ctypes.addressof(src)), ctypes.c_void_p(ctypes.addressof(dst)),
        ctypes.c_int(buffers[0].numel()), ctypes.c_int(buffers[-1].numel()),
    )
    LAUNCHES["hbm_copy"] += 1
    return outs


def mul_add(a, b, c, passes: int = 256, tile: int = 256):
    """The shared-memory stream probe: ``passes`` times
    ``c = a * b + c * 0.9999`` over ``[L, tile]`` tiles staged in shared
    memory, each pass reading ``a``, ``b`` and ``c`` there and writing
    ``c`` back.

    Args:
      a, b, c: float32 ``[L, P]``, contiguous, on one device; ``tile``:
      columns per block, with ``3 * L * tile * 4`` bytes at most 227 KB.

    Returns the new ``c`` ``[L, P]``.
    """
    if a.device.type == "cpu":
        return mul_add_ref(a, b, c, passes, tile)
    _check_mul_add(a, b, c, passes, tile)
    device = _require_cuda(a, b, c)
    _check_launch_size((a,))
    from fastslam_tpu_torch.core import _build

    l, p = a.shape
    out = torch.empty_like(c)
    _launch(
        _build.load().mul_add_launch, device, _ptr(a), _ptr(b), _ptr(c), _ptr(out),
        ctypes.c_int(l), ctypes.c_int(p), ctypes.c_int(tile), ctypes.c_int(passes),
    )
    LAUNCHES["mul_add"] += 1
    return out


def fma_chain(x, passes: int = 256):
    """The FMA probe: ``8 * passes`` dependent fused multiply-adds
    ``x = fma(x, 1.0000001, 1e-7)`` per element, in registers.

    Args:
      x: float32 ``[L, P]``, contiguous.

    Returns the new ``[L, P]`` values.
    """
    if x.device.type == "cpu":
        return fma_chain_ref(x, passes)
    _check_fma_chain(x, passes)
    device = _require_cuda(x)
    _check_launch_size((x,))
    from fastslam_tpu_torch.core import _build

    out = torch.empty_like(x)
    _launch(_build.load().fma_chain_launch, device, _ptr(x), _ptr(out),
            ctypes.c_int(x.numel()), ctypes.c_int(passes))
    LAUNCHES["fma_chain"] += 1
    return out


def icp_point_to_line_fused(source, target, source_valid, target_valid, normals,
                            normal_valid, max_iter: int, tol: float):
    """Point-to-line ICP for a batch of cloud pairs, every iteration of every
    pair in one launch: the while-loop of ``proposal/icp.py``, each pair
    stopping at ``|prev_err - err| < tol`` or after ``max_iter`` iterations,
    decided on the device.

    Args:
      source ``[B, N, 2]``, target ``[B, Mt, 2]`` float32; source_valid
      ``[B, N]``, target_valid ``[B, Mt]`` bool; normals ``[B, Mt, 2]``
      float32 and normal_valid ``[B, Mt]`` bool, the target's normals
      (``proposal/icp.py:estimate_normals``); N, Mt >= 1.

    Returns ``(theta [B], translation [B, 2], mean_error [B], num_iters [B]
    int32)``: the accumulated rotation angle and translation, the last
    iteration's mean NN distance (inf after no iteration), the iterations
    each pair ran.
    """
    if source.device.type == "cpu":
        return icp_point_to_line_ref(source, target, source_valid, target_valid, normals,
                                     normal_valid, max_iter, tol)
    _check_icp_fused_inputs(source, target, source_valid, target_valid, normals,
                            normal_valid, max_iter)
    device = _require_cuda(source, target, source_valid, target_valid, normals,
                           normal_valid)
    b, n = source.shape[:2]
    mt = target.shape[1]
    if b >= 2 ** 31:
        raise ValueError(f"one launch takes fewer than 2^31 cloud pairs, got {b}")
    from fastslam_tpu_torch.core import _build

    p2, _, in_scratch = icp_fused_layout(n, mt)
    scratch = (torch.empty((b, ICP_SUMS * p2 + 2 * n), dtype=torch.float32, device=device)
               if in_scratch else None)
    theta = torch.empty(b, dtype=torch.float32, device=device)
    trans = torch.empty((b, 2), dtype=torch.float32, device=device)
    err = torch.empty(b, dtype=torch.float32, device=device)
    iters = torch.empty(b, dtype=torch.int32, device=device)
    _launch(
        _build.load().icp_point_to_line_launch, device,
        _ptr(source), _ptr(target), _ptr(source_valid), _ptr(target_valid), _ptr(normals),
        _ptr(normal_valid), _ptr(scratch), _ptr(theta), _ptr(trans), _ptr(err),
        _ptr(iters), ctypes.c_int(b), ctypes.c_int(n), ctypes.c_int(mt), ctypes.c_int(p2),
        ctypes.c_int(int(max_iter)), ctypes.c_float(tol), ctypes.c_int(ICP_THREADS),
        ctypes.c_int(ICP_LANES),
    )
    LAUNCHES["icp_point_to_line"] += 1
    return theta, trans, err, iters


def icp_rotation_sin_cos(x):
    """``(sin x, cos x)`` of a float32 vector as the fused ICP kernel rotates
    by them (``csrc/icp_nn.cu``: ``rotation_sin_cos``), in one launch: the
    check that they equal ``torch.sin``/``torch.cos`` on the card."""
    if x.device.type == "cpu":
        return icp_rotation_sin_cos_ref(x)
    _check_sin_cos(x)
    device = _require_cuda(x)
    from fastslam_tpu_torch.core import _build

    s, c = torch.empty_like(x), torch.empty_like(x)
    _launch(_build.load().icp_sin_cos_launch, device, _ptr(x), _ptr(s), _ptr(c),
            ctypes.c_int(x.numel()))
    LAUNCHES["icp_sin_cos"] += 1
    return s, c
