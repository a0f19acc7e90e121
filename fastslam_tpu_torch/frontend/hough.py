"""Hough line and corner detection on fixed-capacity tensors.

Counterpart of ``fastslam_tpu/frontend/hough.py``:

  1. points are scaled and offset into pixel space (scale 100, padding 20,
     offset from the data minimum);
  2. each point is rasterized as a radius-2 disc (a static 13-offset
     expansion), deduplicated per pixel with a sort, so overlapping points
     vote once, like pixels of a binary image;
  3. the (theta, rho) vote accumulator is a float32 ``index_add_`` over a
     ``[T, RHO_BINS]`` grid: exact integer counts for any bin count;
  4. lines are threshold + 4-neighbour local maxima + top-K, ordered by
     (votes descending, flat index ascending) with a stable sort;
  5. production mode refits each line over the scan points near it;
  6. pairwise intersections keep the angle, determinant and in-image gates
     and map back to metric space.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from fastslam_tpu_torch.config import FastSLAMConfig


class HoughLines(NamedTuple):
    rho: torch.Tensor    # [K] pixel-space rho
    theta: torch.Tensor  # [K] radians
    valid: torch.Tensor  # [K] bool


@functools.lru_cache(maxsize=None)
def _disc_offsets_on(radius: int, device: torch.device) -> torch.Tensor:
    """:func:`_disc_offsets` on ``device``, copied there once: a copy from
    the host inside a CUDA graph capture would fail."""
    return torch.from_numpy(_disc_offsets(radius)).to(device)


def _disc_offsets(radius: int) -> np.ndarray:
    """Static pixel offsets of a filled disc."""
    r = int(radius)
    offs = [(dx, dy) for dx in range(-r, r + 1) for dy in range(-r, r + 1)
            if dx * dx + dy * dy <= r * r]
    return np.asarray(offs, np.int32)


def rasterize_offsets(points: torch.Tensor, valid: torch.Tensor,
                      config: FastSLAMConfig):
    """Pixel coordinates and image extent; offsets bring the scaled minimum
    to +padding.  Returns (px [N], py [N], offset_x, offset_y, width, height)
    as int32 tensors."""
    big = 1e9
    sx = points[:, 0] * config.hough_scale
    sy = points[:, 1] * config.hough_scale
    min_x = torch.where(valid, sx, big).amin().to(torch.int32)
    min_y = torch.where(valid, sy, big).amin().to(torch.int32)
    max_x = torch.where(valid, sx, -big).amax().to(torch.int32)
    max_y = torch.where(valid, sy, -big).amax().to(torch.int32)
    pad = config.hough_padding
    offset_x = torch.where(min_x < 0, -min_x, 0) + pad
    offset_y = torch.where(min_y < 0, -min_y, 0) + pad
    width = max_x + offset_x + pad
    height = max_y + offset_y + pad
    px = sx.to(torch.int32) + offset_x
    py = sy.to(torch.int32) + offset_y
    return px, py, offset_x, offset_y, width, height


def theta_table(config: FastSLAMConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the 1-degree theta bins, float32."""
    thetas = (torch.arange(config.hough_num_thetas, dtype=torch.float32, device=device)
              * (math.pi / config.hough_num_thetas))
    return torch.cos(thetas), torch.sin(thetas)


def hough_accumulator(points: torch.Tensor, valid: torch.Tensor,
                      config: FastSLAMConfig):
    """The ``[T, RHO_BINS]`` vote accumulator of a scan.

    Returns (acc float32, offset_x, offset_y, width, height)."""
    device = points.device
    r_bins = config.hough_rho_bins
    px, py, off_x, off_y, width, height = rasterize_offsets(points, valid, config)

    # disc expansion + per-pixel dedup: invalid entries get the max sentinel
    # so they sort to the end; one vote per unique pixel
    offs = _disc_offsets_on(config.hough_point_radius, torch.device(device))
    d = offs.shape[0]
    ex = (px[:, None] + offs[None, :, 0]).reshape(-1)        # [N*D]
    ey = (py[:, None] + offs[None, :, 1]).reshape(-1)
    evalid = valid.repeat_interleave(d)
    sentinel = 2**31 - 1
    pid = torch.where(evalid, ey.clamp(0, 32767) * 32768 + ex.clamp(0, 32767),
                      sentinel)
    pid_s, order = torch.sort(pid, stable=True)
    ex_s = ex[order].to(torch.float32)
    ey_s = ey[order].to(torch.float32)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                       pid_s[1:] != pid_s[:-1]])
    weight = (first & (pid_s < sentinel)).to(torch.float32)

    # rho = x cos(theta) + y sin(theta); points beyond the static extent
    # |rho| < r_bins/2 px do not vote (clipping them into the edge bins would
    # alias far geometry into phantom lines)
    cos_t, sin_t = theta_table(config, device)
    rho = ex_s[:, None] * cos_t[None, :] + ey_s[:, None] * sin_t[None, :]
    rho_idx = torch.round(rho).to(torch.int64) + r_bins // 2
    in_extent = (rho_idx >= 0) & (rho_idx < r_bins)
    rho_idx = rho_idx.clamp(0, r_bins - 1)
    w = weight[:, None] * in_extent.to(torch.float32)          # [N*D, T]
    t_idx = torch.arange(config.hough_num_thetas, device=device)[None, :]
    flat = (t_idx * r_bins + rho_idx).reshape(-1)
    # float32 sums of 0/1 votes are exact integers up to 2^24, in any order
    acc = torch.zeros(config.hough_num_thetas * r_bins, dtype=torch.float32,
                      device=device).index_add_(0, flat, w.reshape(-1))
    return acc.reshape(config.hough_num_thetas, r_bins), off_x, off_y, width, height


def hough_lines(points: torch.Tensor, valid: torch.Tensor,
                config: FastSLAMConfig):
    """Detect up to ``max_hough_lines`` lines in a ``[N, 2]`` scan.

    Returns (lines, offset_x, offset_y, width, height)."""
    t_bins = config.hough_num_thetas
    r_bins = config.hough_rho_bins
    acc, off_x, off_y, width, height = hough_accumulator(points, valid, config)

    # threshold + 4-neighbour local max
    thr = float(config.hough_threshold)
    up = torch.nn.functional.pad(acc, (0, 0, 1, 0))[:-1]
    down = torch.nn.functional.pad(acc, (0, 0, 0, 1))[1:]
    left = torch.nn.functional.pad(acc, (1, 0))[:, :-1]
    right = torch.nn.functional.pad(acc, (0, 1))[:, 1:]
    is_line = (acc >= thr) & (acc > left) & (acc >= right) & (acc > up) & (acc >= down)
    score = torch.where(is_line, acc, -1.0).reshape(-1)
    # top-K in (value desc, flat index asc) order: a stable descending sort
    # keeps equal scores in index order (torch.topk leaves ties unordered)
    k = config.max_hough_lines
    top_score, top_idx = torch.sort(score, descending=True, stable=True)
    top_score, top_idx = top_score[:k], top_idx[:k]
    line_valid = top_score > 0
    t_i = top_idx // r_bins
    r_i = top_idx % r_bins
    rho_f = (r_i - r_bins // 2).to(torch.float32)
    theta_f = t_i.to(torch.float32) * (math.pi / t_bins)
    lines = HoughLines(rho=rho_f, theta=theta_f, valid=line_valid)

    if config.hough_refine and not config.parity_mode:
        # Hough detects on 1 px / 1 degree bins; the scan points estimate
        pxf = points[:, 0] * config.hough_scale + off_x.to(torch.float32)
        pyf = points[:, 1] * config.hough_scale + off_y.to(torch.float32)
        lines = refine_lines_tls(lines, pxf, pyf, valid,
                                 band_px=config.hough_refine_band_px)
    return lines, off_x, off_y, width, height


def refine_lines_tls(lines: HoughLines, pxf: torch.Tensor, pyf: torch.Tensor,
                     valid: torch.Tensor, band_px: float = 3.0) -> HoughLines:
    """Weighted total-least-squares refit of each line over its inliers: the
    line runs through the inlier centroid along the principal direction.  A
    line keeps its Hough estimate when fewer than 3 points are in the band."""
    nx = torch.cos(lines.theta)[:, None]           # [K, 1]
    ny = torch.sin(lines.theta)[:, None]
    d = torch.abs(pxf[None, :] * nx + pyf[None, :] * ny - lines.rho[:, None])
    w = ((d < band_px) & valid[None, :]).to(torch.float32)   # [K, N]
    wsum = torch.sum(w, dim=1)
    ws = torch.clamp_min(wsum, 1e-9)
    cx = torch.sum(w * pxf[None, :], dim=1) / ws
    cy = torch.sum(w * pyf[None, :], dim=1) / ws
    dx = pxf[None, :] - cx[:, None]
    dy = pyf[None, :] - cy[:, None]
    sxx = torch.sum(w * dx * dx, dim=1)
    sxy = torch.sum(w * dx * dy, dim=1)
    syy = torch.sum(w * dy * dy, dim=1)

    # principal direction phi; the normal is phi + pi/2, folded into [0, pi)
    # with rho's sign following
    phi = 0.5 * torch.atan2(2.0 * sxy, sxx - syy)
    theta_n = phi + math.pi / 2.0
    rho_n = cx * torch.cos(theta_n) + cy * torch.sin(theta_n)
    flip = theta_n >= math.pi
    theta_n = torch.where(flip, theta_n - math.pi, theta_n)
    rho_n = torch.where(flip, -rho_n, rho_n)
    neg = theta_n < 0
    theta_n = torch.where(neg, theta_n + math.pi, theta_n)
    rho_n = torch.where(neg, -rho_n, rho_n)

    ok = (wsum >= 3.0) & lines.valid
    return HoughLines(rho=torch.where(ok, rho_n, lines.rho),
                      theta=torch.where(ok, theta_n, lines.theta),
                      valid=lines.valid)


class Intersections(NamedTuple):
    xy: torch.Tensor     # [K*K, 2] metric-space intersection points
    valid: torch.Tensor  # [K*K] bool


def line_intersections(lines: HoughLines, off_x, off_y, width, height,
                       config: FastSLAMConfig) -> Intersections:
    """Pairwise line intersections with the angle, determinant and in-image
    gates, mapped back to metric space."""
    k = lines.rho.shape[0]
    rho1 = lines.rho[:, None]
    rho2 = lines.rho[None, :]
    th1 = lines.theta[:, None]
    th2 = lines.theta[None, :]

    dtheta = torch.abs(th1 - th2)
    dtheta = torch.minimum(dtheta, math.pi - dtheta)
    angle_ok = dtheta >= config.min_line_angle_rad

    a1, b1 = torch.cos(th1), torch.sin(th1)
    a2, b2 = torch.cos(th2), torch.sin(th2)
    det = a1 * b2 - a2 * b1
    det_ok = torch.abs(det) > 1e-10
    det_safe = torch.where(det_ok, det, 1.0)
    x = (b2 * rho1 - b1 * rho2) / det_safe
    y = (a1 * rho2 - a2 * rho1) / det_safe

    iu = torch.arange(k, device=x.device)[:, None]
    ju = torch.arange(k, device=x.device)[None, :]
    pair_ok = (iu < ju) & lines.valid[:, None] & lines.valid[None, :]
    in_img = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    ok = pair_ok & angle_ok & det_ok & in_img

    mx = (x - off_x) / config.hough_scale
    my = (y - off_y) / config.hough_scale
    xy = torch.stack([mx.reshape(-1), my.reshape(-1)], dim=-1)
    return Intersections(xy=xy, valid=ok.reshape(-1))
