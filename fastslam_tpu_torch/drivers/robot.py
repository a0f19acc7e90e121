"""The reference facade: ``Robot``, ``EvaluationUtils`` and ``Serializer``
(counterpart of ``fastslam_tpu/drivers/robot.py``).

``Robot`` mirrors the reference's ``models/robot.py`` over any
:class:`~fastslam_tpu_torch.drivers.base.Driver` instead of the injected
``HAL`` module; ``EvaluationUtils`` mirrors ``utils/evaluation_utils.py``
(offset latch, actual-pose tracking, per-tick deviation metrics);
``Serializer`` mirrors ``utils/serializer.py`` with the same JSON schema.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from fastslam_tpu_torch.config import DEFAULT_CONFIG, FastSLAMConfig
from fastslam_tpu_torch.eval.metrics import evaluate_tick
from fastslam_tpu_torch.models import DirectedPoint, Particle, Point


class Robot(DirectedPoint):
    """The reference ``Robot`` over a Driver: ``scan_environment`` (polar to
    Cartesian with range gating), ``move`` (the bumper-reactive policy),
    ``get_transformation`` (command odometry with the 0.6 fudge) and
    ``get_transformation_icp`` (ICP odometry, on ``device``)."""

    def __init__(self, driver, config: FastSLAMConfig = DEFAULT_CONFIG,
                 x: float = 0.0, y: float = 0.0, yaw: float = 0.0, *,
                 device: torch.device | str = "cuda"):
        super().__init__(x, y, yaw)
        self._driver = driver
        self._config = config
        self._device = torch.device(device)
        self._prev_timestamp = driver.get_laser().timestamp
        self._prev_points: Optional[np.ndarray] = None

    def scan_environment(self) -> np.ndarray:
        """Valid scan points as a dense ``[N, 2]`` array (robot frame)."""
        pts, valid = self._driver.get_laser().to_points()
        return pts[valid]

    def move(self, lin_velocity: float, ang_velocity: float) -> Tuple[float, float]:
        bumper = self._driver.get_bumper()
        if bumper.state == 1:
            v = 0.0
            w = ang_velocity if bumper.bumper == 0 else -ang_velocity
        else:
            v, w = lin_velocity, 0.0
        self._driver.set_velocity(v, w)
        return v, w

    def get_transformation(self, v: float, w: float) -> Tuple[float, float]:
        ts = self._driver.get_laser().timestamp
        dt = ts - self._prev_timestamp
        self._prev_timestamp = ts
        if v != 0:
            return 0.0, v * dt * self._config.velocity_fudge
        return w * dt, 0.0

    def get_transformation_icp(self, target_points: np.ndarray,
                               v: float) -> Tuple[float, float]:
        """Point-to-point ICP from the previous scan's points to these,
        converted to (rotation, translation) odometry; ``(0, 0)`` on the
        first call."""
        from fastslam_tpu_torch.proposal.icp import icp, icp_odometry

        if self._prev_points is None:
            self._prev_points = target_points
            return 0.0, 0.0
        n = max(self._prev_points.shape[0], target_points.shape[0])
        dev = self._device
        pad = lambda a: torch.from_numpy(
            np.pad(a.astype(np.float32), ((0, n - a.shape[0]), (0, 0)))).to(dev)
        mask = lambda a: torch.from_numpy(np.arange(n) < a.shape[0]).to(dev)
        res = icp(pad(self._prev_points), pad(target_points), mask(self._prev_points),
                  mask(target_points), self._config)
        self._prev_points = target_points
        rot, trans = icp_odometry(res, float(v))
        return float(rot), float(trans)


class EvaluationUtils:
    """The reference ``EvaluationUtils`` over a Driver."""

    def __init__(self, driver):
        self._driver = driver
        self.initialized = False
        self._offset = np.zeros(3)
        self._actual_pos = DirectedPoint(0.0, 0.0, 0.0)

    def try_to_initialize(self) -> None:
        """Latch the start pose as the map origin offset.  The reference
        gates on the simulator's known start quadrant; a generic driver
        initializes at once."""
        p = self._driver.get_pose()
        self._offset = np.array([p.x, p.y, p.yaw])
        self.initialized = True

    def set_actual_pos(self) -> None:
        p = self._driver.get_pose()
        self._actual_pos = DirectedPoint(
            p.x - self._offset[0], p.y - self._offset[1],
            (p.yaw - self._offset[2] + np.pi) % (2 * np.pi) - np.pi)

    def evaluate_estimation(self, estimated_pos: DirectedPoint):
        a = self._actual_pos
        res = evaluate_tick((a.x, a.y, a.yaw),
                            (estimated_pos.x, estimated_pos.y, estimated_pos.yaw))
        return res, a


class Serializer:
    """The reference ``Serializer``: the same JSON schema and paths."""

    shared_path = "workspace/shared"
    file_name = "fast_slam.json"

    @classmethod
    def serialize(cls, estimated_robot_pos: DirectedPoint,
                  actual_robot_pos: DirectedPoint, particles: List[Particle],
                  landmarks: List[Point], results) -> None:
        import os

        from fastslam_tpu_torch.io.serializer import serialize_tick

        serialize_tick(
            (estimated_robot_pos.x, estimated_robot_pos.y, estimated_robot_pos.yaw),
            (actual_robot_pos.x, actual_robot_pos.y, actual_robot_pos.yaw),
            np.array([[p.x, p.y, p.yaw] for p in particles]).reshape(-1, 3),
            [(lm.x, lm.y) for lm in landmarks],
            results.to_dict() if hasattr(results, "to_dict") else results,
            path=os.path.join(cls.shared_path, cls.file_name),
        )
