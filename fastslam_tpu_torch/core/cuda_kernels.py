"""The fused measurement-update kernels and their plain PyTorch versions.

Counterpart of ``fastslam_tpu/core/pallas_kernels.py`` for the motion
proposal: one tick (:func:`fused_update_planes`) or C ticks with in-kernel
propagation (:func:`fused_update_planes_multi`) of association, 2x2 landmark
EKF, append and weight update for every particle.  The CUDA kernels live in
``csrc/fused_update.cu`` (one thread per particle); ``core/_build.py``
compiles and loads them.

Each wrapper dispatches on the device of the tensors it is given:

* CUDA tensors launch the kernel, or raise.  There is no fallback.
* CPU tensors run the plain version (``*_ref``), which mirrors the kernel
  operation for operation on ``[L, P]`` tensors.

Both update the landmark planes and ``lm_count`` in place (each particle
owns its column, so the kernel needs no second buffer); the per-tick wrapper
also updates ``log_weights`` in place.  Callers that need the inputs
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

LAUNCHES = {"fused_update_planes": 0, "fused_update_planes_multi": 0}

_LOG_TWO_PI = math.log(2.0 * math.pi)
_PI = math.pi

# packed-argmin sentinel: +inf bits with all slot bits set, larger than any
# usable (finite, non-negative) distance key
_INVALID_KEY = 0x7F8000FF

# dynamic shared memory a block may use without an opt-in attribute
_SMEM_BYTES = 48 * 1024
_MAX_THREADS = 128


def _f32_bits(x: float) -> int:
    """Bit pattern of a non-negative float32 as a Python int."""
    return struct.unpack("<i", struct.pack("<f", float(x)))[0]


# ---------------------------------------------------------------------------
# polynomial trig, shared with the kernels (csrc/fused_update.cu)
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


def _apply_measurement(carry, pose_rows, z_row, *, slot, config: FastSLAMConfig):
    """One measurement through association, 2x2 EKF, append and weighting
    for all particles (``[L, P]`` planes, ``[1, P]`` rows) — what
    ``pallas_kernels._apply_measurement`` computes, and what
    ``apply_measurement`` in ``csrc/fused_update.cu`` computes per thread.

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
    usable = detp > 0.0

    if parity:
        # first hit under the gate, without a divide: d2/det < g^2 (det > 0)
        hit = usable & (d2f < (gate * gate) * detp)
        idx = torch.where(hit, slot, l).amin(dim=0, keepdim=True)
        has_match = idx < l
    else:
        # packed argmin: the non-negative distance's float bits order like
        # the distance; drop 8 mantissa bits and OR the slot into them, so
        # one int32 min gives the winner and its slot (ties -> lower slot)
        inv_det = 1.0 / torch.where(usable, detp, 1.0)
        dist2 = torch.clamp_min(d2f * inv_det, 0.0)
        key = dist2.view(torch.int32)
        key = torch.where(usable, (key & ~0xFF) | slot, _INVALID_KEY)
        kmin = key.amin(dim=0, keepdim=True)
        gate_bits = _f32_bits(gate * gate)
        has_match = kmin <= (((gate_bits - 1) & ~0xFF) | 0xFF)
        idx = kmin & 0xFF

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
    logw = torch.where(do_update, logw + log_lik, logw)
    return mx, my, ca, cb, cc, cd, detp, cnt, logw


def _measurement_loop(carry, pose_rows, z4, zvalid, mlast: int, slot, config):
    for m in range(mlast):
        z_row = (z4[m, 0], z4[m, 1], z4[m, 2], z4[m, 3], zvalid[m] > 0)
        carry = _apply_measurement(carry, pose_rows, z_row, slot=slot, config=config)
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
# checks and launch parameters
# ---------------------------------------------------------------------------

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


def _threads_per_block(l: int, m: int) -> int:
    """Threads per block such that the block's det/validity plane
    (``L * threads`` floats) and the tick's measurement table fit in
    ``_SMEM_BYTES`` of shared memory."""
    table = 5 * m * 4
    threads = min(_MAX_THREADS, (_SMEM_BYTES - table) // (4 * l) // 32 * 32)
    if threads < 32:
        raise ValueError(f"{l} landmark slots and {m} measurements do not fit "
                         "a 32-thread block's shared memory")
    return threads


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
        ctypes.c_int(_threads_per_block(l, m)),
    )
    LAUNCHES["fused_update_planes"] += 1
    return (log_weights, lm_mx, lm_my, lm_ca, lm_cb,
            lm_cc if config.parity_mode else None, lm_cd, lm_count)


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
    z4, zvalid, mlast = _measurement_table(z, z_valid)
    cyaw = torch.cos(poses[:, 2]).contiguous()
    syaw = torch.sin(poses[:, 2]).contiguous()
    cnr = torch.cos(noisy_rot)
    snr = torch.sin(noisy_rot)
    traj = torch.empty((4, c, p), dtype=torch.float32, device=device)
    cc = lm_cc if config.parity_mode else lm_cb
    _launch(
        _build.load().fused_update_planes_multi_launch, device,
        _ptr(poses), _ptr(cyaw), _ptr(syaw), _ptr(log_weights),
        _ptr(noisy_rot), _ptr(noisy_trans), _ptr(cnr), _ptr(snr),
        _ptr(lm_mx), _ptr(lm_my), _ptr(lm_ca), _ptr(lm_cb), _ptr(cc), _ptr(lm_cd),
        _ptr(lm_count), _ptr(z4), _ptr(zvalid), _ptr(mlast),
        _ptr(traj[0]), _ptr(traj[1]), _ptr(traj[2]), _ptr(traj[3]),
        ctypes.c_int(p), ctypes.c_int(l), ctypes.c_int(m), ctypes.c_int(c),
        ctypes.c_int(int(config.parity_mode)), *_gate_args(config),
        ctypes.c_int(_threads_per_block(l, m)),
    )
    LAUNCHES["fused_update_planes_multi"] += 1
    return (traj[0], traj[1], traj[2], traj[3], lm_mx, lm_my, lm_ca, lm_cb,
            lm_cc if config.parity_mode else None, lm_cd, lm_count)
