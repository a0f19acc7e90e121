"""Driver protocol — the reference's ``HAL`` boundary, re-cast (numpy copy
of ``fastslam_tpu/drivers/base.py``).

The reference talks to the JdeRobot simulator through an injected ``HAL``
module (``fast_slam_2/models/robot.py:3`` — laser, bumper, pose, velocity
commands) and cannot run outside that Docker image.  Here the same surface is
a small protocol with two first-class implementations:

* :class:`fastslam_tpu_torch.drivers.sim_world.SimWorld` — a synthetic 2-D world
  with raycast laser, bumper physics and ground truth (the "fake backend" the
  reference never had, SURVEY.md §4);
* :class:`fastslam_tpu_torch.drivers.replay.ReplayDriver` — deterministic log
  replay (BASELINE.json config #1), the CI fixture and the ATE eval harness.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

import numpy as np


@dataclass
class LaserScan:
    """One laser sweep — mirrors HAL.getLaserData() (robot.py:38-58)."""

    values: np.ndarray     # [num_beams] ranges (metres)
    min_range: float
    max_range: float
    timestamp: float       # seconds

    def to_points(self) -> tuple[np.ndarray, np.ndarray]:
        """Polar -> cartesian robot-frame points + validity mask.

        The beam at index i points at ``radians(i - 90)`` relative to the
        robot's heading, exactly as ``robot.py:42-58``; out-of-range beams are
        masked instead of dropped (static shapes).
        """
        n = self.values.shape[0]
        angles = np.radians(np.arange(n) - n // 2)
        valid = (self.values >= self.min_range) & (self.values <= self.max_range)
        x = self.values * np.cos(angles)
        y = self.values * np.sin(angles)
        pts = np.stack([x, y], axis=-1).astype(np.float32)
        pts[~valid] = 0.0
        return pts, valid


@dataclass
class BumperState:
    """HAL.getBumperData() analog (robot.py:66-76)."""

    state: int   # 1 = pressed
    bumper: int  # 0 = right, 1 = center, 2 = left


@dataclass
class Pose:
    x: float
    y: float
    yaw: float


class Driver(Protocol):
    """The minimal simulator surface the control loop needs."""

    def get_laser(self) -> LaserScan: ...
    def get_pose(self) -> Pose: ...
    def get_bumper(self) -> BumperState: ...
    def set_velocity(self, v: float, w: float) -> None: ...
    def step(self) -> bool:
        """Advance one tick; False when the sequence/log is exhausted."""
        ...
