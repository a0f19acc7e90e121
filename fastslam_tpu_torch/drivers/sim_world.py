"""Synthetic 2-D world: raycast laser, bumper physics, ground truth (numpy
copy of ``fastslam_tpu/drivers/sim_world.py``).

The reference can only run inside the JdeRobot Gazebo Docker image; this
module is the deterministic stand-in — a polygonal room traced by a 180-beam
raycaster — used to generate replay logs, drive end-to-end tests, and measure
ATE against known ground truth.  Behavioural details copied from the
reference's environment contract:

* beams point at ``radians(i - 90)`` relative to the heading (robot.py:50);
* the simulator absorbs 40% of the commanded linear velocity — the reference
  compensates with the 0.6 factor at ``robot.py:144`` — so we apply the same
  0.6 factor to the true motion;
* bumper reports right(0)/center(1)/left(2) and the drive policy reacts by
  turning (robot.py:66-82, jde_robots_main.py:25).

Host-side NumPy: this is the world model, not the compute path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from fastslam_tpu_torch.drivers.base import BumperState, LaserScan, Pose


def rectangle(x0: float, y0: float, x1: float, y1: float) -> List[Tuple[float, float, float, float]]:
    """Wall segments of an axis-aligned rectangle."""
    return [
        (x0, y0, x1, y0),
        (x1, y0, x1, y1),
        (x1, y1, x0, y1),
        (x0, y1, x0, y0),
    ]


DEFAULT_WORLD: List[Tuple[float, float, float, float]] = (
    # 10 x 8 room with an inner pillar and an L-wall -> plenty of corners
    rectangle(-5.0, -4.0, 5.0, 4.0)
    + rectangle(1.5, -1.5, 3.0, 0.0)
    + [(-5.0, 1.0, -2.0, 1.0), (-2.0, 1.0, -2.0, 4.0)]
)


@dataclass
class SimWorld:
    """A minimal but honest 2-D differential-drive simulator."""

    segments: List[Tuple[float, float, float, float]] = field(
        default_factory=lambda: list(DEFAULT_WORLD)
    )
    x: float = 0.0
    y: float = 0.0
    yaw: float = 0.0
    dt: float = 0.1
    num_beams: int = 180
    min_range: float = 0.06
    max_range: float = 10.0
    velocity_absorption: float = 0.6   # sim absorbs 40% of commanded v (robot.py:144)
    bumper_distance: float = 0.3
    range_noise_std: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self._segs = np.asarray(self.segments, np.float64)  # [S, 4]
        self._v = 0.0
        self._w = 0.0
        self._t = 0.0
        self._rng = np.random.default_rng(self.seed)

    # ------------------------------------------------------------------ laser
    def _raycast(self, angles: np.ndarray) -> np.ndarray:
        """Min positive hit distance per beam against all wall segments."""
        ox, oy = self.x, self.y
        dx = np.cos(angles)[:, None]                     # [B, 1]
        dy = np.sin(angles)[:, None]
        x1, y1, x2, y2 = (self._segs[:, i][None, :] for i in range(4))  # [1, S]
        ex, ey = x2 - x1, y2 - y1
        denom = dx * ey - dy * ex                        # [B, S]
        denom_safe = np.where(np.abs(denom) < 1e-12, 1.0, denom)
        t = ((x1 - ox) * ey - (y1 - oy) * ex) / denom_safe   # ray param
        s = ((x1 - ox) * dy - (y1 - oy) * dx) / denom_safe   # segment param
        hit = (np.abs(denom) >= 1e-12) & (t > 1e-9) & (s >= 0.0) & (s <= 1.0)
        t = np.where(hit, t, np.inf)
        return np.min(t, axis=1)

    def get_laser(self) -> LaserScan:
        n = self.num_beams
        angles = self.yaw + np.radians(np.arange(n) - n // 2)
        dist = self._raycast(angles)
        if self.range_noise_std > 0:
            dist = dist + self._rng.normal(0, self.range_noise_std, n)
        dist = np.where(np.isfinite(dist), dist, self.max_range + 1.0)
        return LaserScan(
            values=dist.astype(np.float64),
            min_range=self.min_range,
            max_range=self.max_range,
            timestamp=self._t,
        )

    # ----------------------------------------------------------------- bumper
    def get_bumper(self) -> BumperState:
        """Pressed when a wall is within ``bumper_distance`` of the front arc."""
        probes = self.yaw + np.radians(np.array([-35.0, 0.0, 35.0]))
        d = self._raycast(probes)
        if np.min(d) > self.bumper_distance:
            return BumperState(state=0, bumper=1)
        side = int(np.argmin(d))  # 0 = right probe, 1 = center, 2 = left
        return BumperState(state=1, bumper=side)

    # ------------------------------------------------------------------- pose
    def get_pose(self) -> Pose:
        return Pose(self.x, self.y, self.yaw)

    def set_velocity(self, v: float, w: float) -> None:
        self._v, self._w = v, w

    # ------------------------------------------------------------------- step
    def step(self) -> bool:
        v_eff = self._v * self.velocity_absorption
        self.yaw = (self.yaw + self._w * self.dt + np.pi) % (2 * np.pi) - np.pi
        nx = self.x + v_eff * self.dt * np.cos(self.yaw)
        ny = self.y + v_eff * self.dt * np.sin(self.yaw)
        # never drive through a wall: keep position if the step would cross one
        if not self._crosses_wall(self.x, self.y, nx, ny, margin=0.12):
            self.x, self.y = nx, ny
        self._t += self.dt
        return True

    def _crosses_wall(self, x0, y0, x1, y1, margin: float) -> bool:
        """True if segment (x0,y0)-(x1,y1), extended by margin, hits a wall."""
        dx, dy = x1 - x0, y1 - y0
        norm = float(np.hypot(dx, dy))
        if norm < 1e-12:
            return False
        ang = np.arctan2(dy, dx)
        ox, oy = self.x, self.y
        d = self._raycast(np.array([ang]))[0]
        return d <= norm + margin
