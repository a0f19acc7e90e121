"""Array-of-structures data models: the reference's public model surface.

A copy of ``fastslam_tpu/models.py`` (numpy).  The reference exports
``Point / DirectedPoint / Measurement / Landmark / Particle``; the engine
never uses them (its state is tensors, :mod:`fastslam_tpu_torch.core.state`),
but code written against the reference API keeps them as its interchange
types.  ``Particle.from_state`` copies a blocks-layout state to the host and
builds one ``Particle`` per particle.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class Point:
    """A 2-D point (reference models/point.py:4-33)."""

    def __init__(self, x: float, y: float):
        self.x = float(x)
        self.y = float(y)

    def as_vector(self) -> np.ndarray:
        return np.array([self.x, self.y])

    def to_dict(self) -> dict:
        return {"x": self.x, "y": self.y}

    def __repr__(self):
        return f"{type(self).__name__}(x={self.x:.4f}, y={self.y:.4f})"


class DirectedPoint(Point):
    """A point with heading (reference models/directed_point.py:4-28)."""

    def __init__(self, x: float, y: float, yaw: float):
        super().__init__(x, y)
        self.yaw = float(yaw)

    def to_dict(self) -> dict:
        return {"x": self.x, "y": self.y, "yaw": self.yaw}


class Measurement:
    """A (distance, bearing) observation (reference models/measurement.py:4-23)."""

    def __init__(self, distance: float, yaw: float):
        self.distance = float(distance)
        self.yaw = float(yaw)

    def as_vector(self) -> np.ndarray:
        return np.array([self.distance, self.yaw])

    def __repr__(self):
        return f"Measurement(distance={self.distance:.4f}, yaw={self.yaw:.4f})"


class Landmark(Point):
    """A landmark with a 2x2 covariance (reference models/landmark.py:13-28)."""

    def __init__(self, x: float, y: float, cov: Optional[np.ndarray] = None):
        super().__init__(x, y)
        self.cov = (
            np.array([[0.1, 0.0], [0.0, 0.1]]) if cov is None else np.asarray(cov)
        )


class Particle(DirectedPoint):
    """A particle with weight and landmark map (reference models/particle.py:6-20)."""

    def __init__(self, x: float, y: float, yaw: float, weight: float = 0.0,
                 landmarks: Optional[List[Landmark]] = None):
        super().__init__(x, y, yaw)
        self.weight = float(weight)
        self.landmarks: List[Landmark] = landmarks if landmarks is not None else []

    @staticmethod
    def from_state(state, max_particles: Optional[int] = None) -> List["Particle"]:
        """Host copies of a blocks-layout
        :class:`~fastslam_tpu_torch.core.state.FilterState`, one ``Particle``
        per particle (the first ``max_particles``)."""
        host = lambda t: t.detach().cpu().numpy()
        poses = host(state.poses)
        weights = np.exp(host(state.log_weights))
        means = host(state.lm_mean)
        covs = host(state.lm_cov)
        counts = host(state.lm_count)
        n = poses.shape[0] if max_particles is None else min(poses.shape[0], max_particles)
        out = []
        for i in range(n):
            lms = [
                Landmark(means[i, j, 0], means[i, j, 1], covs[i, j].reshape(2, 2))
                for j in range(int(counts[i]))
            ]
            out.append(Particle(*poses[i], weight=float(weights[i]), landmarks=lms))
        return out
