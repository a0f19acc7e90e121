"""Plain PyTorch reference of one chunk of the production filter.

A frozen copy of the arithmetic the port's chunked step computes: the
chunked motion update or the chunked FastSLAM 2.0 update (association by
the packed argmin, the 2x2 landmark EKF, appends, log-weights), the
per-tick estimate rows, then at the chunk boundary the log-sum-exp
normalization, Neff, the systematic resample's staircase and the ancestor
gather.  It follows the published equations operation for operation in the
order the port's kernels round them (polynomial atan, angle-addition
trigonometry, conditional wrap), so on the same device it can agree with
the program bit for bit.

It imports nothing of the program.  The configuration is the cell's plain
dict; the state is a dict of tensors in the planes layout (``[L, P]``
landmark planes, ``[P]`` rows).  Every function computes in the dtype of
the state it is given, so the control runs the same code in bfloat16.
"""

from __future__ import annotations

import math
import struct

import torch

PI = math.pi
LOG_TWO_PI = math.log(2.0 * math.pi)
INVALID_KEY = 0x7F8000FF
PLANES = ("lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cd")
FIELDS = ("poses", "log_weights") + PLANES + ("lm_count",)


def f32_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", float(x)))[0]


def init_state(p: int, l: int, device, dtype=torch.float32) -> dict:
    """All particles at the origin, uniform weights, empty maps."""
    plane = lambda: torch.zeros((l, p), dtype=dtype, device=device)
    state = {name: plane() for name in PLANES}
    state["poses"] = torch.zeros((p, 3), dtype=dtype, device=device)
    state["log_weights"] = torch.full((p,), -math.log(p), dtype=dtype, device=device)
    state["lm_count"] = torch.zeros((p,), dtype=torch.int32, device=device)
    return state


# --------------------------------------------------------------------------
# trigonometry in the kernels' rounding order
# --------------------------------------------------------------------------

def atan_poly(x):
    big = x > 2.414213562373095
    mid = (x > 0.4142135623730950) & ~big
    xr = torch.where(big, -1.0 / torch.where(x == 0.0, 1.0, x),
                     torch.where(mid, (x - 1.0) / (x + 1.0), x))
    base = torch.where(big, PI / 2.0, torch.where(mid, PI / 4.0, 0.0))
    z = xr * xr
    p = (((8.05374449538e-2 * z - 1.38776856032e-1) * z + 1.99777106478e-1)
         * z - 3.33329491539e-1) * z * xr + xr
    return base + p


def atan2(y, x):
    ax, ay = torch.abs(x), torch.abs(y)
    a = atan_poly(ay / torch.where(ax == 0.0, 1.0, ax))
    a = torch.where(ax == 0.0, PI / 2.0, a)
    a = torch.where(x < 0.0, PI - a, a)
    a = torch.where(y < 0.0, -a, a)
    a = torch.where((y == 0.0) & (x < 0.0), PI, a)
    return torch.where((y == 0.0) & (x >= 0.0), 0.0, a)


def wrap_pi(x):
    """To (-pi, pi] for |x| < 3 pi, by conditional subtraction."""
    for _ in range(2):
        x = torch.where(x > PI, x - 2.0 * PI, x)
        x = torch.where(x < -PI, x + 2.0 * PI, x)
    return x


def sin_cos(x):
    """Single-precision minimax (sin, cos) for |x| <= pi."""
    y = torch.abs(x)
    sign_s = torch.where(x < 0.0, -1.0, 1.0)
    hi = y > PI / 2.0
    z = torch.where(hi, PI - y, y)
    sign_c = torch.where(hi, -1.0, 1.0)
    octant = z > PI / 4.0
    w = torch.where(octant, PI / 2.0 - z, z)
    ww = w * w
    sp = ((-1.9515295891e-4 * ww + 8.3321608736e-3) * ww - 1.6666654611e-1) * ww * w + w
    cp = ((2.443315711809948e-5 * ww - 1.388731625493765e-3) * ww
          + 4.166664568298827e-2) * ww * ww - 0.5 * ww + 1.0
    return sign_s * torch.where(octant, cp, sp), sign_c * torch.where(octant, sp, cp)


# --------------------------------------------------------------------------
# one measurement: association, EKF, append, weight
# --------------------------------------------------------------------------

def packed_argmin(d2f, detp, slot, gate: float):
    """The best slot under the gate: the distance's float32 bits with the
    slot in the low byte, one integer min (ties to the lower slot)."""
    usable = detp > 0.0
    dist2 = torch.clamp_min(d2f * (1.0 / torch.where(usable, detp, 1.0)), 0.0)
    key = dist2.to(torch.float32).view(torch.int32)
    key = torch.where(usable, (key & ~0xFF) | slot, INVALID_KEY)
    kmin = key.amin(dim=0, keepdim=True)
    has_match = kmin <= (((f32_bits(gate * gate) - 1) & ~0xFF) | 0xFF)
    return has_match, kmin & 0xFF


def apply_measurement(carry, pose, z_row, slot, cfg, weight_update=True):
    """carry (mx, my, ca, cb, cd, detp, cnt, logw), pose rows (px, py, yaw,
    cos yaw, sin yaw), z_row (range, bearing, cos b, sin b, valid)."""
    mx, my, ca, cb, cd, detp, cnt, logw = carry
    px, py, yaw, cyaw, syaw = pose
    dist_z, bearing_z, cos_b, sin_b, z_ok = z_row
    rn, dc, l = float(cfg["measurement_noise"]), float(cfg["default_landmark_cov"]), mx.shape[0]

    wx = px + dist_z * (cyaw * cos_b - syaw * sin_b)
    wy = py + dist_z * (syaw * cos_b + cyaw * sin_b)
    dxq, dyq = mx - wx, my - wy
    d2f = dxq * (cd * dxq - cb * dyq) + dyq * (-cb * dxq + ca * dyq)
    has_match, idx = packed_argmin(d2f, detp, slot, float(cfg["max_landmark_distance"]))

    gi = idx.clamp(max=l - 1).long()
    mu_x, mu_y = mx.gather(0, gi), my.gather(0, gi)
    a, b, d = ca.gather(0, gi), cb.gather(0, gi), cd.gather(0, gi)
    c = b
    dx, dy = mu_x - px, mu_y - py
    q = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    rinv = 1.0 / torch.sqrt(q)
    qinv = rinv * rinv
    nu_r = dist_z - q * rinv
    nu_b = wrap_pi(bearing_z + yaw - atan2(dy, dx))
    h00, h01, h10, h11 = dx * rinv, dy * rinv, -dy * qinv, dx * qinv

    u0, u1 = h00 * a + h01 * c, h00 * b + h01 * d
    v0, v1 = h10 * a + h11 * c, h10 * b + h11 * d
    s00 = u0 * h00 + u1 * h01 + rn
    s01 = u0 * h10 + u1 * h11
    s10 = v0 * h00 + v1 * h01
    s11 = v0 * h10 + v1 * h11 + rn
    s_det = s00 * s11 - s01 * s10
    sdi = 1.0 / (torch.clamp_min(torch.abs(s_det), 1e-18) * torch.sign(s_det + 1e-30))
    i00, i01, i10, i11 = s11 * sdi, -s01 * sdi, -s10 * sdi, s00 * sdi

    m0, m1 = a * h00 + b * h01, c * h00 + d * h01
    n0, n1 = a * h10 + b * h11, c * h10 + d * h11
    k00, k01 = m0 * i00 + n0 * i10, m0 * i01 + n0 * i11
    k10, k11 = m1 * i00 + n1 * i10, m1 * i01 + n1 * i11
    new_x = mu_x + k00 * nu_r + k01 * nu_b
    new_y = mu_y + k10 * nu_r + k11 * nu_b
    g00 = 1.0 - (k00 * h00 + k01 * h10)
    g01 = -(k00 * h01 + k01 * h11)
    g10 = -(k10 * h00 + k11 * h10)
    g11 = 1.0 - (k10 * h01 + k11 * h11)
    new_a, new_d = g00 * a + g01 * c, g10 * b + g11 * d
    off = 0.5 * ((g00 * b + g01 * d) + (g10 * a + g11 * c))   # Joseph-symmetrized
    maha = i00 * nu_r * nu_r + (i01 + i10) * nu_r * nu_b + i11 * nu_b * nu_b
    log_lik = -0.5 * (maha + torch.log(torch.clamp_min(s_det, 1e-30))) - LOG_TWO_PI

    do_update = has_match & z_ok
    do_append = (~has_match) & (cnt < l) & z_ok
    tgt = ((slot == idx) & do_update) | ((slot == cnt) & do_append)
    row = lambda u, v: torch.where(do_update, u, v)
    mx = torch.where(tgt, row(new_x, wx), mx)
    my = torch.where(tgt, row(new_y, wy), my)
    ca = torch.where(tgt, row(new_a, dc), ca)
    cb = torch.where(tgt, row(off, 0.0), cb)
    cd = torch.where(tgt, row(new_d, dc), cd)
    detp = torch.where(tgt, row(new_a * new_d - off * off, dc * dc), detp)
    cnt = cnt + do_append.to(torch.int32)
    if weight_update:
        logw = torch.where(do_update, logw + log_lik, logw)
    return mx, my, ca, cb, cd, detp, cnt, logw


def measurement_table(z, z_valid, dtype):
    """``[C, M, 4]`` (range, bearing, cos b, sin b), valid flags, and the
    per-tick trip count (last valid index + 1)."""
    z = z.to(dtype)
    z4 = torch.cat([z, torch.cos(z[..., 1:2]), torch.sin(z[..., 1:2])], dim=-1)
    ranks = torch.arange(1, z.shape[-2] + 1, dtype=torch.int32, device=z.device)
    trips = torch.where(z_valid, ranks, 0).amax(dim=-1)
    return z4, z_valid, trips.tolist()


def z_row(z4, valid, m):
    return z4[m, 0], z4[m, 1], z4[m, 2], z4[m, 3], valid[m]


def measurements(carry, pose, z4, valid, trips, slot, cfg, weight_update=True):
    for m in range(trips):
        carry = apply_measurement(carry, pose, z_row(z4, valid, m), slot, cfg, weight_update)
    return carry


# --------------------------------------------------------------------------
# the FastSLAM 2.0 proposal
# --------------------------------------------------------------------------

def accumulate_proposal(acc, planes, pred, prior, z_row_, slot, cfg, scale):
    """One measurement of the Gauss-Newton pose information at the
    predicted pose, behind the 9.21 chi^2 gate; with evidence weights, the
    evidence log-weight."""
    lam00, lam01, lam02, lam11, lam12, lam22, e0a, e1a, e2a, logw_add = acc
    mx, my, ca, cb, cd, detp = planes
    px, py, yaw, cyaw, syaw = pred
    p00, p01, p11, s_r2 = prior
    dist_z, bearing_z, cos_b, sin_b, z_ok = z_row_
    rn, l = float(cfg["measurement_noise"]), mx.shape[0]

    wx = px + dist_z * (cyaw * cos_b - syaw * sin_b)
    wy = py + dist_z * (syaw * cos_b + cyaw * sin_b)
    dxq, dyq = mx - wx, my - wy
    d2f = dxq * (cd * dxq - cb * dyq) + dyq * (-cb * dxq + ca * dyq)
    has_match, idx = packed_argmin(d2f, detp, slot, float(cfg["max_landmark_distance"]))
    use = has_match & z_ok
    gi = idx.clamp(max=l - 1).long()
    take = lambda plane: torch.where(has_match, plane.gather(0, gi), 0.0)
    mu_x, mu_y, a, b, d = take(mx), take(my), take(ca), take(cb), take(cd)
    c = b
    dx, dy = mu_x - px, mu_y - py
    q = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    rinv = 1.0 / torch.sqrt(q)
    qinv = rinv * rinv
    nu_r = dist_z - q * rinv
    nu_b = wrap_pi(bearing_z + yaw - atan2(dy, dx))
    h00, h01, h10, h11 = dx * rinv, dy * rinv, -dy * qinv, dx * qinv
    u0, u1 = h00 * a + h01 * c, h00 * b + h01 * d
    v0, v1 = h10 * a + h11 * c, h10 * b + h11 * d
    s00 = u0 * h00 + u1 * h01 + rn
    s01 = u0 * h10 + u1 * h11
    s11 = v0 * h10 + v1 * h11 + rn
    si = 1.0 / torch.clamp_min(s00 * s11 - s01 * s01, 1e-18)
    i00, i01, i11 = s11 * si, -s01 * si, s00 * si
    use = use & ((i00 * nu_r * nu_r + 2.0 * i01 * nu_r * nu_b + i11 * nu_b * nu_b) < 9.21)

    g00, g01, g10, g11 = -h00, -h01, -h10, -h11
    t00, t01, t02 = i00 * g00 + i01 * g10, i00 * g01 + i01 * g11, -i01
    t10, t11, t12 = i01 * g00 + i11 * g10, i01 * g01 + i11 * g11, -i11
    luse = use.to(mx.dtype) * scale
    lam00 = lam00 + luse * (g00 * t00 + g10 * t10)
    lam01 = lam01 + luse * (g00 * t01 + g10 * t11)
    lam02 = lam02 + luse * (g00 * t02 + g10 * t12)
    lam11 = lam11 + luse * (g01 * t01 + g11 * t11)
    lam12 = lam12 + luse * (g01 * t02 + g11 * t12)
    lam22 = lam22 + luse * (-t12)
    e0a = e0a + luse * (t00 * nu_r + t10 * nu_b)
    e1a = e1a + luse * (t01 * nu_r + t11 * nu_b)
    e2a = e2a + luse * (t02 * nu_r + t12 * nu_b)
    if cfg["fs2_evidence_weights"]:
        q00 = g00 * (p00 * g00 + p01 * g01) + g01 * (p01 * g00 + p11 * g01)
        q01 = g00 * (p00 * g10 + p01 * g11) + g01 * (p01 * g10 + p11 * g11)
        q11 = g10 * (p00 * g10 + p01 * g11) + g11 * (p01 * g10 + p11 * g11) + s_r2
        z00, z01, z11 = s00 + q00, s01 + q01, s11 + q11
        z_det = torch.clamp_min(z00 * z11 - z01 * z01, 1e-30)
        maha = (z11 * nu_r * nu_r - 2.0 * z01 * nu_r * nu_b + z00 * nu_b * nu_b) * (1.0 / z_det)
        logw_add = torch.where(use, logw_add + (-0.5 * (maha + torch.log(z_det)) - LOG_TWO_PI),
                               logw_add)
    return lam00, lam01, lam02, lam11, lam12, lam22, e0a, e1a, e2a, logw_add


def sample_pose(lam, eta, pred, noise):
    """Sigma = Lambda^-1, mu = pred + Sigma eta, pose = mu + chol(Sigma +
    1e-9 I) n, the yaw wrapped."""
    l00, l01, l02, l11, l12, l22 = lam
    e0, e1, e2 = eta
    px, py, yaw = pred
    n0, n1, n2 = noise
    co00, co01, co02 = l11 * l22 - l12 * l12, l02 * l12 - l01 * l22, l01 * l12 - l02 * l11
    det = l00 * co00 + l01 * co01 + l02 * co02
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-18, det, 1e-18)
    s00, s01, s02 = co00 * inv_det, co01 * inv_det, co02 * inv_det
    s11 = (l00 * l22 - l02 * l02) * inv_det
    s12 = (l01 * l02 - l00 * l12) * inv_det
    s22 = (l00 * l11 - l01 * l01) * inv_det
    mu0 = px + s00 * e0 + s01 * e1 + s02 * e2
    mu1 = py + s01 * e0 + s11 * e1 + s12 * e2
    mu2 = yaw + s02 * e0 + s12 * e1 + s22 * e2
    c00 = torch.sqrt(torch.clamp_min(s00 + 1e-9, 1e-18))
    c10, c20 = s01 / c00, s02 / c00
    c11 = torch.sqrt(torch.clamp_min((s11 + 1e-9) - c10 * c10, 1e-18))
    c21 = (s12 - c20 * c10) / c11
    c22 = torch.sqrt(torch.clamp_min((s22 + 1e-9) - c20 * c20 - c21 * c21, 1e-18))
    return (mu0 + c00 * n0, mu1 + c10 * n0 + c11 * n1,
            wrap_pi(mu2 + c20 * n0 + c21 * n1 + c22 * n2))


def fs2_tick(carry, pred, z4, valid, trips, slot, prior_row, noise, cfg):
    """Accumulate at the predicted pose, solve and sample, then the EKF at
    the sampled pose."""
    mx, my, ca, cb, cd, detp, cnt, logw = carry
    s_t2, s_r2, fxy, dial = prior_row
    cy, sy = pred[3], pred[4]
    p00 = cy * cy * s_t2 + sy * sy * fxy
    p01 = cy * sy * (s_t2 - fxy)
    p11 = sy * sy * s_t2 + cy * cy * fxy
    i_p = 1.0 / torch.clamp_min(p00 * p11 - p01 * p01, 1e-18)
    zero = torch.zeros_like(p00)
    acc = (p11 * i_p, -p01 * i_p, zero, p00 * i_p, zero, (1.0 / s_r2) * torch.ones_like(p00),
           zero, zero, zero, torch.zeros_like(logw))
    prior = (p00, p01, p11, s_r2 * torch.ones_like(p00))
    for m in range(trips):
        acc = accumulate_proposal(acc, (mx, my, ca, cb, cd, detp), pred, prior,
                                  z_row(z4, valid, m), slot, cfg, dial)
    evidence = bool(cfg["fs2_evidence_weights"])
    if evidence:
        logw = logw + acc[9]
    x, y, yaw = sample_pose(acc[:6], acc[6:9], pred[:3], noise)
    syaw, cyaw = sin_cos(yaw)
    pose = (x, y, yaw, cyaw, syaw)
    carry = measurements((mx, my, ca, cb, cd, detp, cnt, logw), pose, z4, valid, trips,
                         slot, cfg, weight_update=not evidence)
    return pose, carry


# --------------------------------------------------------------------------
# one chunk
# --------------------------------------------------------------------------

def chunk_update(state: dict, rotations, translations, z, z_valid, draws: dict, cfg,
                 fs2: bool):
    """C ticks of the update from ``state`` (never changed).  Returns the
    per-tick trajectory ``(x, y, yaw, logw)``, each ``[C, P]``, and the
    state after the chunk with its last tick's poses and raw weights."""
    dt = state["poses"].dtype
    l, p = state["lm_mx"].shape
    dev = state["poses"].device
    c = rotations.shape[0]
    z4, valid, trips = measurement_table(z, z_valid, dt)
    slot = torch.arange(l, dtype=torch.int32, device=dev)[:, None]
    mx, my, ca, cb, cd = (state[k].clone() for k in PLANES)
    cnt = state["lm_count"].reshape(1, p)
    detp = torch.where(slot < cnt, ca * cd - cb * cb, -1.0)
    carry = (mx, my, ca, cb, cd, detp, cnt, state["log_weights"].reshape(1, p))
    yaw = state["poses"][:, 2].reshape(1, p)
    pose = (state["poses"][:, 0].reshape(1, p), state["poses"][:, 1].reshape(1, p), yaw,
            torch.cos(yaw), torch.sin(yaw))
    rotating = rotations != 0.0
    traj = torch.empty((4, c, p), dtype=dt, device=dev)
    if fs2:
        fxy = float(cfg["proposal_xy_floor"]) ** 2
        fth = float(cfg["proposal_theta_floor"]) ** 2
        rot_eff = torch.where(rotating, rotations, 0.0).to(dt)
        trans_eff = torch.where(rotating, 0.0, translations).to(dt)
        s_t2 = (torch.where(rotating, 0.0, float(cfg["translation_noise"]) ** 2) + fxy).to(dt)
        s_r2 = (torch.where(rotating, float(cfg["rotation_noise"]) ** 2, 0.0) + fth).to(dt)
        cr, sr = torch.cos(rot_eff), torch.sin(rot_eff)
        for k in range(c):
            px, py, yaw, cyaw, syaw = pose
            yaw = wrap_pi(yaw + rot_eff[k])
            cyaw, syaw = cyaw * cr[k] - syaw * sr[k], syaw * cr[k] + cyaw * sr[k]
            pred = (px + trans_eff[k] * cyaw, py + trans_eff[k] * syaw, yaw, cyaw, syaw)
            prior_row = (s_t2[k], s_r2[k], torch.full((), fxy, dtype=dt, device=dev),
                         torch.ones((), dtype=dt, device=dev))
            noise = tuple(draws["noise"][k, i:i + 1].to(dt) for i in range(3))
            pose, carry = fs2_tick(carry, pred, z4[k], valid[k], trips[k], slot, prior_row,
                                   noise, cfg)
            traj[:3, k] = torch.cat(pose[:3])
            traj[3, k] = carry[7][0]
    else:
        rot_noise = float(cfg["rotation_noise"]) * draws["rot"]
        trans_noise = float(cfg["translation_noise"]) * draws["trans"]
        nrot = torch.where(rotating[:, None], rotations[:, None] + rot_noise, 0.0).to(dt)
        ntrans = torch.where(rotating[:, None], 0.0, translations[:, None] + trans_noise).to(dt)
        cnr, snr = torch.cos(nrot), torch.sin(nrot)
        for k in range(c):
            px, py, yaw, cyaw, syaw = pose
            yaw = wrap_pi(yaw + nrot[k])
            cyaw, syaw = cyaw * cnr[k] - syaw * snr[k], syaw * cnr[k] + cyaw * snr[k]
            inv_n = 1.0 / torch.sqrt(cyaw * cyaw + syaw * syaw)
            cyaw, syaw = cyaw * inv_n, syaw * inv_n
            pose = (px + ntrans[k] * cyaw, py + ntrans[k] * syaw, yaw, cyaw, syaw)
            carry = measurements(carry, pose, z4[k], valid[k], trips[k], slot, cfg)
            traj[:3, k] = torch.cat(pose[:3])
            traj[3, k] = carry[7][0]
    out = dict(zip(PLANES, carry[:5]))
    out["lm_count"] = carry[6].reshape(p)
    out["poses"] = torch.stack([traj[0, c - 1], traj[1, c - 1], traj[2, c - 1]], dim=-1)
    out["log_weights"] = traj[3, c - 1].clone()
    return traj, out


def estimates(traj):
    """Per tick, the pose of the first particle of largest log-weight."""
    x, y, yaw, logw = traj
    best = torch.argmax(logw, dim=1)
    ticks = torch.arange(x.shape[0], device=x.device)
    return torch.stack([x[ticks, best], y[ticks, best], yaw[ticks, best]], dim=-1)


# --------------------------------------------------------------------------
# the chunk boundary: normalize, Neff, systematic resample
# --------------------------------------------------------------------------

def fixed_order_cumsum(w):
    """Cumulative weights summed exactly in int64 units of 2^-48."""
    scale = 2.0 ** 48
    q = torch.round(w.to(torch.float64) * scale).to(torch.int64)
    return (torch.cumsum(q, dim=0).to(torch.float64) / scale).to(w.dtype)


def staircase(cum, u0, n: int):
    """``clip(searchsorted(cum, u0 + arange(n)/n, 'left'), 0, n-1)``,
    counted in closed form and inverted by a scatter-max and a prefix
    max."""
    dt, dev = cum.dtype, cum.device
    u0 = torch.as_tensor(u0, dtype=dt, device=dev)
    grid = lambda m: u0 + m.to(dt) / n
    s = torch.clamp(torch.ceil((cum - u0) * n).to(torch.int64), 0, n)
    for _ in range(2):
        s = torch.where((s > 0) & (grid(s - 1) > cum), s - 1, s)
    for _ in range(2):
        s = torch.where((s < n) & (grid(s) <= cum), s + 1, s)
    s_prev = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), s[:-1]])
    j = torch.arange(n, dtype=torch.int64, device=dev)
    start = torch.where(s > s_prev, s_prev, n)
    b = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    b = b.scatter_reduce(0, start, j, reduce="amax", include_self=True)
    tail = torch.where(s[n - 1] < n, s[n - 1], n).reshape(1)
    b = b.scatter_reduce(0, tail, torch.full((1,), n - 1, dtype=torch.int64, device=dev),
                         reduce="amax", include_self=True)
    return torch.clamp(torch.cummax(b[:n], dim=0).values, 0, n - 1)


def boundary(state: dict, u0, cfg):
    """Normalize the log-weights; where Neff < frac * P, gather every
    particle from its systematic-resample ancestor and reset the weights
    to uniform.  Returns ``(state, resampled)``."""
    p = state["poses"].shape[0]
    logw = state["log_weights"] - torch.logsumexp(state["log_weights"], dim=0)
    w = torch.exp(logw)
    s = torch.sum(w * w)
    neff = torch.where(s < 1.0 / p, float(p), 1.0 / torch.clamp_min(s, 1e-300))
    out = dict(state, log_weights=logw)
    if not bool(neff < float(cfg["resample_threshold_frac"]) * p):
        return out, False
    idx = staircase(fixed_order_cumsum(w), u0, p)
    out = {k: v.index_select(1 if k in PLANES else 0, idx) for k, v in out.items()}
    out["log_weights"] = torch.full((p,), -math.log(p), dtype=logw.dtype, device=logw.device)
    return out, True


def chunk(state: dict, rotations, translations, z, z_valid, draws: dict, cfg, fs2: bool):
    """One chunk from ``state``: returns ``(estimates [C, 3], state)``."""
    traj, out = chunk_update(state, rotations, translations, z, z_valid, draws, cfg, fs2)
    return estimates(traj), boundary(out, draws["u0"], cfg)[0]
