"""Plain PyTorch and NumPy reference of one online tick.

A frozen copy of what the port's fused online tick computes, in the order
its kernels and torch operations round it:

* the perception frontend: scan points, the Hough accumulator over
  rasterized discs, local maxima, the total-least-squares refit, pairwise
  line intersections, eps-clustering, the corner gate, and the compaction
  into (range, bearing) measurements;
* the warm-started point-to-line ICP of scan t-1 (and, with adaptive
  floors, of scan t-2) onto scan t, each pair iterated to the tolerance;
* the command-versus-match blend and the adaptive floor estimator's
  read-before-push moments (host NumPy);
* one filter tick: the motion proposal and the landmark EKF, or the
  FastSLAM 2.0 proposal, then the normalization, Neff, the systematic
  resample and the estimate of the highest-weight particle.

It imports nothing of the program.  The configuration is the cell's plain
field dict as a namespace; the filter state is a dict of tensors in the
planes layout.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.reference import filter as rf

TWO_PI = 2.0 * math.pi
N_OUT = 14


def namespace(fields: dict) -> SimpleNamespace:
    return SimpleNamespace(**fields)


def wrap_angle(theta):
    return torch.remainder(theta + math.pi, TWO_PI) - math.pi


def rotate_points(points, theta):
    theta = torch.as_tensor(theta, dtype=points.dtype, device=points.device)
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = points[..., 0], points[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


# --------------------------------------------------------------------------
# frontend
# --------------------------------------------------------------------------

def gaussian_kernel(sigma: float, truncate: float) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    if radius <= 0:
        return np.ones((1,), np.float32)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def line_filter(points, cfg):
    kernel = gaussian_kernel(cfg.line_filter_sigma, cfg.line_filter_truncate)
    if kernel.shape[0] == 1:
        return points
    r = kernel.shape[0] // 2
    padded = torch.cat([points[:r].flip(0), points, points[-r:].flip(0)], dim=0)
    k = torch.from_numpy(kernel).to(points.device)
    n = points.shape[0]
    idx = (torch.arange(n, device=points.device)[:, None]
           + torch.arange(kernel.shape[0], device=points.device)[None, :])
    return torch.einsum("nkc,k->nc", padded[idx], k)


def disc_offsets(radius: int, device) -> torch.Tensor:
    r = int(radius)
    offs = [(dx, dy) for dx in range(-r, r + 1) for dy in range(-r, r + 1)
            if dx * dx + dy * dy <= r * r]
    return torch.from_numpy(np.asarray(offs, np.int32)).to(device)


def hough_accumulator(points, valid, cfg):
    device = points.device
    r_bins = cfg.hough_rho_bins
    big = 1e9
    sx = points[:, 0] * cfg.hough_scale
    sy = points[:, 1] * cfg.hough_scale
    min_x = torch.where(valid, sx, big).amin().to(torch.int32)
    min_y = torch.where(valid, sy, big).amin().to(torch.int32)
    max_x = torch.where(valid, sx, -big).amax().to(torch.int32)
    max_y = torch.where(valid, sy, -big).amax().to(torch.int32)
    pad = cfg.hough_padding
    off_x = torch.where(min_x < 0, -min_x, 0) + pad
    off_y = torch.where(min_y < 0, -min_y, 0) + pad
    width, height = max_x + off_x + pad, max_y + off_y + pad
    px, py = sx.to(torch.int32) + off_x, sy.to(torch.int32) + off_y

    offs = disc_offsets(cfg.hough_point_radius, device)
    d = offs.shape[0]
    ex = (px[:, None] + offs[None, :, 0]).reshape(-1)
    ey = (py[:, None] + offs[None, :, 1]).reshape(-1)
    evalid = valid.repeat_interleave(d)
    sentinel = 2 ** 31 - 1
    pid = torch.where(evalid, ey.clamp(0, 32767) * 32768 + ex.clamp(0, 32767), sentinel)
    pid_s, order = torch.sort(pid, stable=True)
    ex_s, ey_s = ex[order].to(torch.float32), ey[order].to(torch.float32)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=device), pid_s[1:] != pid_s[:-1]])
    weight = (first & (pid_s < sentinel)).to(torch.float32)

    thetas = (torch.arange(cfg.hough_num_thetas, dtype=torch.float32, device=device)
              * (math.pi / cfg.hough_num_thetas))
    cos_t, sin_t = torch.cos(thetas), torch.sin(thetas)
    rho = ex_s[:, None] * cos_t[None, :] + ey_s[:, None] * sin_t[None, :]
    rho_idx = torch.round(rho).to(torch.int64) + r_bins // 2
    in_extent = (rho_idx >= 0) & (rho_idx < r_bins)
    rho_idx = rho_idx.clamp(0, r_bins - 1)
    w = weight[:, None] * in_extent.to(torch.float32)
    t_idx = torch.arange(cfg.hough_num_thetas, device=device)[None, :]
    flat = (t_idx * r_bins + rho_idx).reshape(-1)
    acc = torch.zeros(cfg.hough_num_thetas * r_bins, dtype=torch.float32,
                      device=device).index_add_(0, flat, w.reshape(-1))
    return acc.reshape(cfg.hough_num_thetas, r_bins), off_x, off_y, width, height


def refine_lines(rho, theta, line_valid, pxf, pyf, valid, band_px):
    nx, ny = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    d = torch.abs(pxf[None, :] * nx + pyf[None, :] * ny - rho[:, None])
    w = ((d < band_px) & valid[None, :]).to(torch.float32)
    wsum = torch.sum(w, dim=1)
    ws = torch.clamp_min(wsum, 1e-9)
    cx = torch.sum(w * pxf[None, :], dim=1) / ws
    cy = torch.sum(w * pyf[None, :], dim=1) / ws
    dx, dy = pxf[None, :] - cx[:, None], pyf[None, :] - cy[:, None]
    sxx = torch.sum(w * dx * dx, dim=1)
    sxy = torch.sum(w * dx * dy, dim=1)
    syy = torch.sum(w * dy * dy, dim=1)
    phi = 0.5 * torch.atan2(2.0 * sxy, sxx - syy)
    theta_n = phi + math.pi / 2.0
    rho_n = cx * torch.cos(theta_n) + cy * torch.sin(theta_n)
    flip = theta_n >= math.pi
    theta_n = torch.where(flip, theta_n - math.pi, theta_n)
    rho_n = torch.where(flip, -rho_n, rho_n)
    neg = theta_n < 0
    theta_n = torch.where(neg, theta_n + math.pi, theta_n)
    rho_n = torch.where(neg, -rho_n, rho_n)
    ok = (wsum >= 3.0) & line_valid
    return torch.where(ok, rho_n, rho), torch.where(ok, theta_n, theta)


def hough_lines(points, valid, cfg):
    t_bins, r_bins = cfg.hough_num_thetas, cfg.hough_rho_bins
    acc, off_x, off_y, width, height = hough_accumulator(points, valid, cfg)
    pad = torch.nn.functional.pad
    up, down = pad(acc, (0, 0, 1, 0))[:-1], pad(acc, (0, 0, 0, 1))[1:]
    left, right = pad(acc, (1, 0))[:, :-1], pad(acc, (0, 1))[:, 1:]
    is_line = ((acc >= float(cfg.hough_threshold)) & (acc > left) & (acc >= right)
               & (acc > up) & (acc >= down))
    score = torch.where(is_line, acc, -1.0).reshape(-1)
    k = cfg.max_hough_lines
    top_score, top_idx = torch.sort(score, descending=True, stable=True)
    top_score, top_idx = top_score[:k], top_idx[:k]
    line_valid = top_score > 0
    rho = (top_idx % r_bins - r_bins // 2).to(torch.float32)
    theta = (top_idx // r_bins).to(torch.float32) * (math.pi / t_bins)
    if cfg.hough_refine and not cfg.parity_mode:
        pxf = points[:, 0] * cfg.hough_scale + off_x.to(torch.float32)
        pyf = points[:, 1] * cfg.hough_scale + off_y.to(torch.float32)
        rho, theta = refine_lines(rho, theta, line_valid, pxf, pyf, valid,
                                  cfg.hough_refine_band_px)
    return (rho, theta, line_valid), off_x, off_y, width, height


def line_intersections(lines, off_x, off_y, width, height, cfg):
    rho, theta, line_valid = lines
    k = rho.shape[0]
    rho1, rho2, th1, th2 = rho[:, None], rho[None, :], theta[:, None], theta[None, :]
    dtheta = torch.abs(th1 - th2)
    dtheta = torch.minimum(dtheta, math.pi - dtheta)
    angle_ok = dtheta >= math.radians(cfg.min_line_angle_deg)
    a1, b1, a2, b2 = torch.cos(th1), torch.sin(th1), torch.cos(th2), torch.sin(th2)
    det = a1 * b2 - a2 * b1
    det_ok = torch.abs(det) > 1e-10
    det_safe = torch.where(det_ok, det, 1.0)
    x = (b2 * rho1 - b1 * rho2) / det_safe
    y = (a1 * rho2 - a2 * rho1) / det_safe
    iu = torch.arange(k, device=x.device)[:, None]
    ju = torch.arange(k, device=x.device)[None, :]
    pair_ok = (iu < ju) & line_valid[:, None] & line_valid[None, :]
    in_img = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    ok = pair_ok & angle_ok & det_ok & in_img
    xy = torch.stack([((x - off_x) / cfg.hough_scale).reshape(-1),
                      ((y - off_y) / cfg.hough_scale).reshape(-1)], dim=-1)
    return xy, ok.reshape(-1)


def clusters(points, valid, eps: float, iters: int = 16):
    """Connected components of the eps-graph, min-label propagation with
    pointer jumping; centroids summed over a dense membership mask."""
    n = points.shape[0]
    diff = points[:, None, :] - points[None, :, :]
    adj = (torch.sum(diff * diff, dim=-1) <= eps * eps) & valid[:, None] & valid[None, :]
    idx = torch.arange(n, device=points.device)
    labels = torch.where(valid, idx, n)
    for _ in range(iters):
        labels = torch.minimum(labels, torch.where(adj, labels[None, :], n).amin(dim=1))
        labels = torch.where(valid, torch.minimum(labels, labels[labels.clamp(max=n - 1)]), n)
    safe = torch.where(valid, labels, n - 1)
    member = (safe[None, :] == idx[:, None]) & valid[None, :]
    count = member.sum(dim=1).to(points.dtype)
    sx = torch.where(member, points[None, :, 0], 0.0).sum(dim=1)
    sy = torch.where(member, points[None, :, 1], 0.0).sum(dim=1)
    denom = torch.clamp_min(count, 1.0)
    centroid = torch.stack([(sx / denom)[safe], (sy / denom)[safe]], dim=-1)
    return centroid, valid & (labels == idx)


def measurements(points, valid, cfg):
    """Scan ``[N, 2]`` -> padded ``([M, 2] range/bearing, [M] valid)``."""
    filtered = line_filter(points, cfg)
    lines, off_x, off_y, width, height = hough_lines(filtered, valid, cfg)
    xy, ok = line_intersections(lines, off_x, off_y, width, height, cfg)
    centroid, is_rep = clusters(xy, ok, cfg.cluster_eps)
    diff = centroid[:, None, :] - filtered[None, :, :]
    d2 = torch.where(valid[None, :], torch.sum(diff * diff, dim=-1), torch.inf)
    corner_ok = is_rep & (d2.amin(dim=1) <= cfg.corner_threshold ** 2)
    dist = torch.sqrt(torch.sum(centroid * centroid, dim=-1))
    bearing = torch.atan2(centroid[:, 1], centroid[:, 0])
    take = torch.sort((~corner_ok).to(torch.int32), stable=True).indices[:cfg.max_measurements]
    return torch.stack([dist[take], bearing[take]], dim=-1), corner_ok[take]


# --------------------------------------------------------------------------
# point-to-line ICP
# --------------------------------------------------------------------------

def tree_sum(x):
    """Sum over the last axis pairwise from a power of two, the kernel's
    order."""
    n = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, (1 << max(n - 1, 0).bit_length()) - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def normals_of(points, valid):
    nxt, prv = torch.roll(points, -1, dims=-2), torch.roll(points, 1, dims=-2)
    tangent = nxt - prv
    norm = torch.sqrt(torch.sum(tangent * tangent, dim=-1, keepdim=True))
    ok = (valid & torch.roll(valid, -1, dims=-1) & torch.roll(valid, 1, dims=-1)
          & (norm[..., 0] > 1e-9))
    t_unit = tangent / torch.clamp_min(norm, 1e-9)
    return torch.stack([-t_unit[..., 1], t_unit[..., 0]], dim=-1), ok


def icp(source, target, source_valid, target_valid, max_iter: int, tol: float):
    """Batched point-to-line ICP ``[B, N, 2]`` -> ``[B, Mt, 2]``; each pair
    frozen once ``|prev_err - err| < tol``.  Returns ``(theta [B],
    translation [B, 2])``."""
    normals, n_ok = normals_of(target, target_valid)
    b = source.shape[0]
    dev, dt = source.device, source.dtype
    sw = source_valid.to(dt)
    nq = torch.cat([normals, n_ok.to(dt)[..., None]], dim=-1)
    gather = lambda pts, idx: torch.gather(pts, 1, idx[..., None].expand(*idx.shape,
                                                                         pts.shape[-1]))
    src = source
    theta_total = torch.zeros(b, dtype=dt, device=dev)
    trans_total = torch.zeros((b, 2), dtype=dt, device=dev)
    prev_err = torch.full((b,), torch.inf, dtype=dt, device=dev)
    converged = torch.zeros(b, dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        if bool(converged.all()):
            break
        active = ~converged
        diff = src[..., :, None, :] - target[..., None, :, :]
        d2 = torch.where(target_valid[..., None, :], torch.sum(diff * diff, dim=-1), torch.inf)
        idx = torch.argmin(d2, dim=-1, keepdim=True)
        dist = torch.sqrt(torch.gather(d2, -1, idx))[..., 0]
        idx = idx[..., 0]
        q, ng = gather(target, idx), gather(nq, idx)
        nx, ny = ng[..., 0], ng[..., 1]
        w = sw * ng[..., 2]
        sx, sy = src[..., 0], src[..., 1]
        r = (sx - q[..., 0]) * nx + (sy - q[..., 1]) * ny
        j0 = sx * ny - sy * nx
        wj0, wj1, wj2 = w * j0, w * nx, w * ny
        sums = tree_sum(torch.stack([wj0 * j0, wj0 * nx, wj0 * ny, wj1 * nx, wj1 * ny,
                                     wj2 * ny, wj0 * r, wj1 * r, wj2 * r, dist * w, w], dim=1))
        h00, h01, h02 = sums[:, 0] + 1e-9, sums[:, 1], sums[:, 2]
        h11, h12, h22 = sums[:, 3] + 1e-9, sums[:, 4], sums[:, 5] + 1e-9
        b0, b1, b2 = -sums[:, 6], -sums[:, 7], -sums[:, 8]
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
        new_src = torch.stack([c[:, None] * sx - s[:, None] * sy + tx[:, None],
                               s[:, None] * sx + c[:, None] * sy + ty[:, None]], dim=-1)
        tt0, tt1 = trans_total[:, 0], trans_total[:, 1]
        new_tt = torch.stack([c * tt0 - s * tt1 + tx, s * tt0 + c * tt1 + ty], dim=-1)
        src = torch.where(active[:, None, None], new_src, src)
        trans_total = torch.where(active[:, None], new_tt, trans_total)
        theta_total = torch.where(active, theta_total + theta, theta_total)
        conv = torch.abs(prev_err - err) < tol
        prev_err = torch.where(active, err, prev_err)
        converged = torch.where(active, conv, converged)
    return theta_total, trans_total


# --------------------------------------------------------------------------
# the adaptive floor estimator (host)
# --------------------------------------------------------------------------

CHI2_MED = 0.4549364231195736
CHI2_2_MED_HALF = float(np.log(2.0))


def robust_var(window, scale=CHI2_MED) -> float:
    return float(np.median(window)) / scale if window else 0.0


class FloorEstimator:
    """Trailing per-tick-type windows of ICP-versus-command residuals;
    ``read`` gives the next tick's floors, blends, dial and gates from the
    residuals pushed before it."""

    NAMES = ("rw_th", "rw_al", "rw_lat", "qw_th", "qw_xy")

    def __init__(self, cfg, windows: dict):
        self.cfg = cfg
        self.w = {name: {k: list(v) for k, v in windows[name].items()} for name in self.NAMES}

    def _push(self, name, k, v):
        w = self.w[name][k]
        w.append(float(v))
        if len(w) > self.cfg.floor_window:
            w.pop(0)

    def _get(self, name, k):
        return self.w[name][k] if self.w[name][k] else self.w[name][1 - k]

    def push(self, k, sr_th=None, sr_al=None, lat=None, d_ang=None, d_t2=None):
        if sr_th is not None:
            self._push("rw_th", k, sr_th)
            self._push("rw_al", k, sr_al)
            self._push("rw_lat", k, lat ** 2)
        if d_ang is not None:
            self._push("qw_th", k, d_ang ** 2 / 3.0)
            self._push("qw_xy", k, d_t2 / 6.0)

    def read(self, k):
        cfg = self.cfg
        lo, hi = cfg.proposal_floor_min, cfg.proposal_floor_max
        n0 = cfg.floor_prior_ticks
        th_w, al_w, lat_w = self.w["rw_th"][k], self.w["rw_al"][k], self.w["rw_lat"][k]
        b_th = float(np.median(th_w)) if th_w else 0.0
        b_al = float(np.median(al_w)) if al_w else 0.0
        lam_th = max(0.0, (n0 - len(th_w)) / n0)
        lam_al = max(0.0, (n0 - len(al_w)) / n0)
        m_th_data = robust_var([(v - b_th) ** 2 for v in th_w])
        m_al_data = robust_var([(v - b_al) ** 2 for v in al_w])
        m_th = lam_th * cfg.floor_prior_sigma_theta ** 2 + (1 - lam_th) * m_th_data
        m_al = lam_al * cfg.floor_prior_sigma_xy ** 2 + (1 - lam_al) * m_al_data
        m_lat = robust_var(lat_w) if lat_w else m_al
        m_lat_data = robust_var(lat_w) if lat_w else m_al_data
        q_th = robust_var(self._get("qw_th", k))
        q_xy = robust_var(self._get("qw_xy", k), CHI2_2_MED_HALF)
        q_th_eff = q_th + 1.57 * m_th_data / max(len(th_w), 1)
        q_xy_eff = max(q_xy + 1.57 * m_al_data / max(len(al_w), 1), m_lat_data)
        so_xy = lam_al * cfg.floor_prior_sigma_xy ** 2 + (1 - lam_al) * max(m_al_data - q_xy_eff, 0.0)
        so_th = (lam_th * cfg.floor_prior_sigma_theta ** 2
                 + (1 - lam_th) * max(m_th_data - q_th_eff, 0.0))
        a_xy = (so_xy / max(m_al, 1e-12)
                if np.sqrt(so_xy) > cfg.blend_min_sigma and len(al_w) >= 4 else 0.0)
        a_th = (so_th / max(m_th, 1e-12)
                if np.sqrt(so_th) > cfg.blend_min_sigma_theta and len(th_w) >= 4 else 0.0)
        fxy = float(np.clip(np.sqrt((1 - a_xy) ** 2 * so_xy + a_xy ** 2 * q_xy_eff), lo, hi))
        fth = float(np.clip(np.sqrt((1 - a_th) ** 2 * so_th + a_th ** 2 * q_th_eff), lo, hi))
        ramp = lambda s: float(np.clip((s - cfg.fs2_dial_lo_floor)
                                       / max(cfg.fs2_dial_hi_floor - cfg.fs2_dial_lo_floor, 1e-9),
                                       0.0, 1.0))
        dial = max(ramp(fxy), ramp(fth)) if cfg.fs2_mode_dial else 1.0
        lat_gate = cfg.blend_match_gate * float(np.sqrt(max(m_lat, 1e-10))) + 1e-3
        return fxy, fth, a_xy, a_th, dial, b_th, lat_gate


def se2_residuals(angs, tvecs, rots, trans):
    """Signed rotation, along-track and lateral ICP-versus-command
    residuals of ticks 1..T-1 (tick 0 zeroed), in float32."""
    t_total = len(rots)
    sr_th, sr_al, lat = (np.zeros(t_total, np.float32) for _ in range(3))
    av, tv = np.asarray(angs), np.asarray(tvecs)
    sr_th[1:] = ((-av - rots[1:]) + np.pi) % (2 * np.pi) - np.pi
    sr_al[1:] = -(tv[:, 0] + trans[1:])
    lat[1:] = tv[:, 1]
    return sr_th, sr_al, lat


def consistency_discrepancy(angs, tvecs, dir_ang, dir_t):
    """Direct two-step matches against the composition of two single
    steps: ``(d_ang, d_t2)``."""
    a1, t1 = np.asarray(angs)[:-1], np.asarray(tvecs)[:-1]
    a2, t2 = np.asarray(angs)[1:], np.asarray(tvecs)[1:]
    c2, s2 = np.cos(a2), np.sin(a2)
    c_t = np.stack([c2 * t1[:, 0] - s2 * t1[:, 1], s2 * t1[:, 0] + c2 * t1[:, 1]], -1) + t2
    d_ang = (np.asarray(dir_ang) - (a1 + a2) + np.pi) % (2 * np.pi) - np.pi
    return d_ang, ((np.asarray(dir_t) - c_t) ** 2).sum(-1)


def push_tick(est: FloorEstimator, k, out, rotation, translation, has_prev, has_prev2,
              prev_se2):
    """The tick's residuals into the estimator, as the online loop pushes
    them after the tick; returns the match ``(ang, tx, ty)`` it keeps."""
    ang, tx, ty = float(out[8]), float(out[9]), float(out[10])
    kw = {}
    if has_prev:
        sr, al, la = se2_residuals(np.array([ang], np.float32), np.array([[tx, ty]], np.float32),
                                   np.array([0.0, rotation], np.float32),
                                   np.array([0.0, translation], np.float32))
        kw.update(sr_th=float(sr[1]), sr_al=float(al[1]), lat=float(la[1]))
    if has_prev2:
        pa, ptx, pty = prev_se2
        d_ang, d_t2 = consistency_discrepancy(
            np.array([pa, ang], np.float32), np.array([[ptx, pty], [tx, ty]], np.float32),
            np.array([out[11]], np.float32), np.array([[out[12], out[13]]], np.float32))
        kw.update(d_ang=float(d_ang[0]), d_t2=float(d_t2[0]))
    est.push(k, **kw)
    return ang, tx, ty


# --------------------------------------------------------------------------
# one tick
# --------------------------------------------------------------------------

def motion_update(state, rotation, translation, z, z_valid, draws, cfg):
    """Propagate (exact trigonometry, floor-mod wrap), then the tick's
    measurements through association, EKF and weights."""
    p = state["poses"].shape[0]
    rotating = rotation != 0.0
    nrot = torch.where(rotating, rotation + cfg.rotation_noise * draws["rot"], 0.0)
    ntrans = torch.where(rotating, 0.0, translation + cfg.translation_noise * draws["trans"])
    yaw = wrap_angle(state["poses"][:, 2] + nrot)
    x = state["poses"][:, 0] + ntrans * torch.cos(yaw)
    y = state["poses"][:, 1] + ntrans * torch.sin(yaw)
    poses = torch.stack([x, y, yaw], dim=-1)
    carry, rows, z4, valid, trips, slot = _start(state, poses, z, z_valid)
    carry = rf.measurements(carry, rows, z4, valid, trips, slot, vars(cfg))
    return _finish(state, poses, carry)


def fs2_update(state, rotation, translation, z, z_valid, draws, cfg, floors, dial):
    """Mean-motion prediction, then the FastSLAM 2.0 tick: accumulate at
    the predicted pose, sample, EKF at the sampled pose."""
    dev = state["poses"].device
    rotating = rotation != 0.0
    fxy_f, fth_f = floors if floors is not None else (cfg.proposal_xy_floor,
                                                       cfg.proposal_theta_floor)
    fxy, fth = fxy_f ** 2, fth_f ** 2
    rot_eff = torch.where(rotating, rotation, 0.0)
    trans_eff = torch.where(rotating, 0.0, translation)
    s_t2 = torch.where(rotating, 0.0, cfg.translation_noise ** 2) + fxy
    s_r2 = torch.where(rotating, cfg.rotation_noise ** 2, 0.0) + fth
    yaw = wrap_angle(state["poses"][:, 2] + rot_eff)
    pred = torch.stack([state["poses"][:, 0] + trans_eff * torch.cos(yaw),
                        state["poses"][:, 1] + trans_eff * torch.sin(yaw), yaw], dim=-1)
    carry, rows, z4, valid, trips, slot = _start(state, pred, z, z_valid)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    prior = (f32(s_t2), f32(s_r2), f32(fxy), f32(1.0 if dial is None else dial))
    p = pred.shape[0]
    noise = tuple(draws["noise"][:, i].reshape(1, p) for i in range(3))
    rows, carry = rf.fs2_tick(carry, rows, z4, valid, trips, slot, prior, noise, vars(cfg))
    poses = torch.stack([r.reshape(p) for r in rows[:3]], dim=-1)
    return _finish(state, poses, carry)


def _start(state, poses, z, z_valid):
    l, p = state["lm_mx"].shape
    z4, valid, trips = rf.measurement_table(z[None], z_valid[None], torch.float32)
    slot = torch.arange(l, dtype=torch.int32, device=poses.device)[:, None]
    cnt = state["lm_count"].reshape(1, p)
    ca, cb, cd = state["lm_ca"], state["lm_cb"], state["lm_cd"]
    detp = torch.where(slot < cnt, ca * cd - cb * cb, -1.0)
    carry = (state["lm_mx"], state["lm_my"], ca, cb, cd, detp, cnt,
             state["log_weights"].reshape(1, p))
    yaw = poses[:, 2].reshape(1, p)
    rows = (poses[:, 0].reshape(1, p), poses[:, 1].reshape(1, p), yaw, torch.cos(yaw),
            torch.sin(yaw))
    return carry, rows, z4[0], valid[0], trips[0], slot


def _finish(state, poses, carry):
    p = poses.shape[0]
    out = dict(zip(rf.PLANES, carry[:5]))
    out.update(poses=poses, lm_count=carry[6].reshape(p), log_weights=carry[7].reshape(p))
    return out


def tick(state, prev, prev2, points, valid, scalars, draws, cfg, fs2: bool,
         icp_dtype=torch.float32):
    """One fused tick from ``state`` and the scans ``prev``/``prev2``
    (``(points, valid)``) with the host scalars ``scalars`` (float32: the
    odometry, the previous command, the flags, the floors, blends, bias,
    lateral gate and dial); the ICP computes in ``icp_dtype``, the filter in
    the dtype of ``state``.  Returns ``(out [14], state after)``."""
    dev = points.device
    f = lambda v: torch.tensor(np.float32(v), device=dev)
    (rotation, translation, rot_prev, trans_prev, v_active, has_prev, has_prev2,
     fxy, fth, a_xy, a_th, b_th, lat_gate, dial) = (f(v) for v in scalars)
    v_active, has_prev, has_prev2 = v_active > 0.5, has_prev > 0.5, has_prev2 > 0.5
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ang, t_comp = zero, torch.zeros(2, dtype=torch.float32, device=dev)
    dir_ang, dir_t = zero, torch.zeros(2, dtype=torch.float32, device=dev)
    floors_on = cfg.adaptive_proposal_floors
    if cfg.use_icp_proposal:
        n = points.shape[0]
        prev_pts = torch.where(has_prev, prev[0], points)
        prev_vld = torch.where(has_prev, prev[1], valid)
        srcs = [rotate_points(prev_pts, -rotation) - torch.stack([translation, zero])]
        src_vld = [prev_vld]
        if floors_on:
            prev2_pts = torch.where(has_prev2, prev2[0], points)
            prev2_vld = torch.where(has_prev2, prev2[1], valid)
            warm2_ang = -(rot_prev + rotation)
            warm2_t = (rotate_points(torch.stack([-trans_prev, zero]), -rotation)
                       + torch.stack([-translation, zero]))
            srcs.append(rotate_points(prev2_pts, warm2_ang) + warm2_t)
            src_vld.append(prev2_vld)
        k = len(srcs)
        theta, trans = icp(torch.stack(srcs).to(icp_dtype), points.expand(k, n, 2).to(icp_dtype),
                           torch.stack(src_vld), valid.expand(k, n), cfg.icp_max_iterations,
                           cfg.icp_tolerance)
        theta, trans = theta.float(), trans.float()
        ang = theta[0] - rotation
        t_comp = rotate_points(torch.stack([-translation, zero]), theta[0]) + trans[0]
        icp_trans = torch.where(v_active, -t_comp[0], 0.0)
        icp_rot = torch.where(v_active, 0.0, -ang - b_th)
        if floors_on:
            dir_ang = warm2_ang + theta[1]
            dir_t = rotate_points(warm2_t, theta[1]) + trans[1]
            match_ok = (torch.abs(t_comp[1]) <= lat_gate).to(torch.float32)
            a_r, a_t = a_th * match_ok, a_xy * match_ok
        else:
            a_r = a_t = torch.full((), cfg.icp_blend, dtype=torch.float32, device=dev)
        rotation = torch.where(has_prev, (1 - a_r) * rotation + a_r * icp_rot, rotation)
        translation = torch.where(has_prev, (1 - a_t) * translation + a_t * icp_trans,
                                  translation)
    z, z_valid = measurements(points, valid, cfg)
    if fs2:
        after = fs2_update(state, rotation, translation, z, z_valid, draws, cfg,
                           (fxy, fth) if floors_on else None, dial if floors_on else None)
    else:
        after = motion_update(state, rotation, translation, z, z_valid, draws, cfg)
    after, _ = rf.boundary(after, draws["u0"], vars(cfg))
    best = torch.argmax(after["log_weights"]).reshape(1)
    est = after["poses"].index_select(0, best)[0]
    n_meas = z_valid.sum().to(torch.float32)
    out = torch.cat([est, torch.stack([rotation, translation, n_meas, fxy, fth, ang,
                                       t_comp[0], t_comp[1], dir_ang, dir_t[0], dir_t[1]])])
    return out, after
