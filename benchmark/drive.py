"""The recorded drive of the online traffic: a 180-beam laser in a
polygonal room, driven by the reference's bumper policy.

A frozen copy of the repository's simulator (the raycaster, the bumper
probes, the 0.6 absorption of the commanded speed, the bumper-reactive
policy), so that a later change to the program's simulator cannot move
the traffic.  A traffic file gives the room, the policy's speeds, the
laser and the start pose, so every seed drives the same scans; the seed
draws the wheel slip.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def rectangle(x0, y0, x1, y1):
    return [(x0, y0, x1, y0), (x1, y0, x1, y1), (x1, y1, x0, y1), (x0, y1, x0, y0)]


def walls(spec: dict) -> np.ndarray:
    segs = [tuple(s) for s in spec.get("segments", [])]
    for r in spec.get("rectangles", []):
        segs += rectangle(*r)
    return np.asarray(segs, np.float64)


def raycast(segs: np.ndarray, x: float, y: float, angles: np.ndarray) -> np.ndarray:
    """The nearest positive hit distance of each ray against the walls."""
    dx, dy = np.cos(angles)[:, None], np.sin(angles)[:, None]
    x1, y1, x2, y2 = (segs[:, i][None, :] for i in range(4))
    ex, ey = x2 - x1, y2 - y1
    denom = dx * ey - dy * ex
    safe = np.where(np.abs(denom) < 1e-12, 1.0, denom)
    t = ((x1 - x) * ey - (y1 - y) * ex) / safe
    s = ((x1 - x) * dy - (y1 - y) * dx) / safe
    hit = (np.abs(denom) >= 1e-12) & (t > 1e-9) & (s >= 0.0) & (s <= 1.0)
    return np.min(np.where(hit, t, np.inf), axis=1)


@dataclass
class Drive:
    """``T`` ticks: robot-frame scan points ``[T, B, 2]`` float32 and
    validity ``[T, B]``, timestamps, the commands issued at each tick,
    ground truth, and the wheel slip each tick's active odometry
    component takes."""

    points: np.ndarray
    valid: np.ndarray
    timestamps: np.ndarray
    cmd_v: np.ndarray
    cmd_w: np.ndarray
    gt: np.ndarray
    slip_rot: np.ndarray
    slip_trans: np.ndarray

    def __len__(self) -> int:
        return len(self.timestamps)


def record(spec: dict, seed: int, num_ticks: int) -> Drive:
    """Drive ``num_ticks`` ticks from the traffic's start pose, with wheel
    slip drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    segs = walls(spec["world"])
    x, y, yaw = spec["start_pose"]
    laser = spec["laser"]
    n, dt = laser["beams"], spec["dt"]
    rel = np.radians(np.arange(n) - n // 2)
    probes = np.radians(np.array([-35.0, 0.0, 35.0]))
    values = np.empty((num_ticks, n))
    gt = np.empty((num_ticks, 3))
    cmd_v, cmd_w = np.empty(num_ticks), np.empty(num_ticks)
    rays = np.concatenate([rel, probes])
    for t in range(num_ticks):
        hits = raycast(segs, x, y, yaw + rays)     # the beams, then the bumper probes
        dist, d = hits[:n], hits[n:]
        if np.min(d) > spec["bumper_distance"]:
            v, w = spec["v_cmd"], 0.0
        else:
            v, w = 0.0, spec["w_cmd"] if int(np.argmin(d)) == 0 else -spec["w_cmd"]
        values[t] = np.where(np.isfinite(dist), dist, laser["max_range"] + 1.0)
        gt[t] = (x, y, yaw)
        cmd_v[t], cmd_w[t] = v, w
        # one simulator step; never through a wall
        v_eff = v * spec["velocity_absorption"]
        yaw = (yaw + w * dt + np.pi) % (2 * np.pi) - np.pi
        nx, ny = x + v_eff * dt * np.cos(yaw), y + v_eff * dt * np.sin(yaw)
        step = float(np.hypot(nx - x, ny - y))
        if step < 1e-12 or raycast(segs, x, y, np.array([np.arctan2(ny - y, nx - x)]))[0] > step + 0.12:
            x, y = nx, ny
    valid = (values >= laser["min_range"]) & (values <= laser["max_range"])
    pts = np.stack([values * np.cos(rel), values * np.sin(rel)], axis=-1).astype(np.float32)
    pts[~valid] = 0.0
    slip_r, slip_t = spec["slip"]
    return Drive(points=pts, valid=valid, timestamps=np.arange(num_ticks) * dt,
                 cmd_v=cmd_v, cmd_w=cmd_w, gt=gt,
                 slip_rot=rng.normal(0.0, slip_r, num_ticks) if slip_r else np.zeros(num_ticks),
                 slip_trans=rng.normal(0.0, slip_t, num_ticks) if slip_t else np.zeros(num_ticks))
