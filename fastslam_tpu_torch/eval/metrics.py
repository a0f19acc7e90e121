"""Evaluation: the reference's per-tick deviation metrics + proper ATE.

Formulas from ``fast_slam_2/utils/evaluation_utils.py``:

* linear deviation %: |actual - estimated| * 100   (1 m == 100%, :110-123)
* angular deviation %: |wrap(actual - estimated)| / pi * 100  (:126-140)
* euclidean distance between poses (:77)
* average of the three percentages (:89-97)

plus what the reference never computes (SURVEY.md §6): absolute trajectory
error (ATE) over a whole run — RMSE of positional error, no alignment, since
estimate and ground truth share a frame by construction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TickEvaluation:
    average_deviation: float
    x_deviation: float
    y_deviation: float
    angular_deviation: float
    distance: float

    def to_dict(self) -> dict:
        """JSON schema compatible with the reference viewer
        (``serializer.py:36-43`` / ``landmark_map/utils/deserializer.py``)."""
        from datetime import datetime

        return {
            "timestamp": datetime.now().strftime("%m/%d/%Y %I:%M:%S %p"),
            "average_deviation": round(self.average_deviation, 2),
            "x_deviation": round(self.x_deviation, 2),
            "y_deviation": round(self.y_deviation, 2),
            "angular_deviation": round(self.angular_deviation, 2),
            "distance": round(self.distance, 4),
        }


def wrap_angle(a: float) -> float:
    return (a + np.pi) % (2 * np.pi) - np.pi


def evaluate_tick(actual, estimated) -> TickEvaluation:
    """actual/estimated: (x, y, yaw) triples."""
    dx = actual[0] - estimated[0]
    dy = actual[1] - estimated[1]
    x_dev = abs(dx) * 100.0
    y_dev = abs(dy) * 100.0
    ang = abs(wrap_angle(abs(actual[2] - estimated[2])))
    ang_dev = ang / np.pi * 100.0
    dist = float(np.hypot(dx, dy))
    return TickEvaluation(
        average_deviation=float((x_dev + y_dev + ang_dev) / 3.0),
        x_deviation=float(x_dev),
        y_deviation=float(y_dev),
        angular_deviation=float(ang_dev),
        distance=dist,
    )


def ate_rmse(gt_xy: np.ndarray, est_xy: np.ndarray) -> float:
    """Absolute trajectory error: RMSE of positional error, shared frame."""
    err = np.asarray(gt_xy, float) - np.asarray(est_xy, float)
    return float(np.sqrt(np.mean(np.sum(err * err, axis=-1))))


def align_se2(gt_xy: np.ndarray, est_xy: np.ndarray) -> np.ndarray:
    """Best-fit SE(2) transform (Horn/Umeyama closed form: rotation +
    translation, no scale) carrying ``est_xy`` onto ``gt_xy``; returns the
    transformed estimate.

    Standard ATE practice for SLAM backends: a pose graph's gauge freedom
    (anchored at one keyframe, global rotation constrained only by that
    anchor's heading prior) leaves a globally-rotated-but-internally-exact
    solution, and the raw shared-frame error then measures the gauge, not
    the map (at a 4 km survey a 1 mrad anchor slack is ~4 m at the far
    end).  Filter-path metrics keep the raw shared-frame convention.
    """
    gt = np.asarray(gt_xy, float)
    est = np.asarray(est_xy, float)
    mu_g = gt.mean(axis=0)
    mu_e = est.mean(axis=0)
    a = est - mu_e
    b = gt - mu_g
    cos_acc = float((a * b).sum())
    sin_acc = float((a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]).sum())
    th = np.arctan2(sin_acc, cos_acc)
    c, s = np.cos(th), np.sin(th)
    rot = np.array([[c, -s], [s, c]])
    return a @ rot.T + mu_g


def ate_rmse_aligned(gt_xy: np.ndarray, est_xy: np.ndarray) -> float:
    """ATE RMSE after best-fit SE(2) alignment (see :func:`align_se2`)."""
    return ate_rmse(gt_xy, align_se2(gt_xy, est_xy))


def trajectory_metrics(gt_poses: np.ndarray, est_poses: np.ndarray) -> dict:
    """Summary metrics over a full run ([T, 3] arrays)."""
    gt = np.asarray(gt_poses, float)
    est = np.asarray(est_poses, float)
    dist = np.linalg.norm(gt[:, :2] - est[:, :2], axis=1)
    ang = np.abs([wrap_angle(a) for a in (gt[:, 2] - est[:, 2])])
    return {
        "ate_rmse_m": ate_rmse(gt[:, :2], est[:, :2]),
        "mean_distance_m": float(dist.mean()),
        "max_distance_m": float(dist.max()),
        "final_distance_m": float(dist[-1]),
        "mean_angular_error_rad": float(np.mean(ang)),
    }
