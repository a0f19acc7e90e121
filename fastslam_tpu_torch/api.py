"""Reference-compatible API facades.

Counterpart of ``fastslam_tpu/api.py``: drop-in equivalents of the
reference's algorithm and utility classes (``FastSLAM2``, ``LineFilter``,
``HoughTransformation``, ``ICP``, ``GeometryUtils``, ``LandmarkUtils``), each
a thin host-facing wrapper over the port's tensor engine.  Every facade runs
on the card (``device="cuda"``) unless it is asked for the CPU.  PyTorch runs
eagerly, so there is no compiled-function cache to keep.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from fastslam_tpu_torch.config import DEFAULT_CONFIG, FastSLAMConfig
from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import FilterState, init_state, pad_measurements
from fastslam_tpu_torch.frontend import clustering as _clustering
from fastslam_tpu_torch.frontend import pipeline as _pipeline
from fastslam_tpu_torch.frontend.global_map import cluster_known_landmarks
from fastslam_tpu_torch.frontend.hough import hough_lines, line_intersections
from fastslam_tpu_torch.frontend.line_filter import line_filter as _line_filter
from fastslam_tpu_torch.models import Landmark, Measurement, Particle
from fastslam_tpu_torch.proposal import icp as _icp


def _points(points, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(points, np.float32).reshape(-1, 2), device=device)


class FastSLAM2:
    """Drop-in equivalent of the reference ``FastSLAM2`` class: construct,
    then call ``iterate(rotation, translation, measurements)`` per tick and
    read ``.particles``.  Each iteration is one
    :func:`~fastslam_tpu_torch.core.kernels.fastslam_step` on the
    blocks-layout state (on a card, one launch of the per-tick update
    kernel), with draws from a :class:`torch.Generator` seeded from
    ``rng``."""

    def __init__(self, config: FastSLAMConfig = DEFAULT_CONFIG, rng: int = 0, *,
                 device: torch.device | str = "cuda"):
        self.config = config
        self.device = torch.device(device)
        self.state: FilterState = init_state(config, self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(rng)

    def iterate(self, rotation: float, translation: float,
                measurements: List[Measurement]) -> Tuple[float, float, float]:
        """One filter iteration; returns the estimated (x, y, yaw)."""
        rb = [(m.distance, m.yaw) for m in measurements]
        ms = pad_measurements(self.config, np.asarray(rb, np.float32).reshape(-1, 2),
                              self.device)
        draws = kernels.draw(self._generator, self.config.num_particles,
                             fs2=kernels.uses_fs2(self.config))
        self.state, pose = kernels.fastslam_step(self.state, float(rotation),
                                                 float(translation), ms, self.config,
                                                 draws)
        x, y, yaw = pose.tolist()
        return float(x), float(y), float(yaw)

    @property
    def particles(self) -> List[Particle]:
        """One ``Particle`` per particle (host copies of the state)."""
        return Particle.from_state(self.state)


class LineFilter:
    """Reference ``LineFilter``: the Gaussian smoothing of a scan."""

    @staticmethod
    def filter(points: np.ndarray, sigma: float = 0.1,
               device: torch.device | str = "cuda") -> np.ndarray:
        cfg = DEFAULT_CONFIG.replace(line_filter_sigma=float(sigma))
        return _line_filter(_points(points, device), cfg).cpu().numpy()


class HoughTransformation:
    """Reference ``HoughTransformation``: the metric-space line intersections
    of a scan."""

    @staticmethod
    def detect_line_intersections(points: np.ndarray,
                                  config: FastSLAMConfig = DEFAULT_CONFIG,
                                  device: torch.device | str = "cuda"
                                  ) -> List[Tuple[float, float]]:
        pts = _points(points, device)
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
        lines, ox, oy, w, h = hough_lines(pts, valid, config)
        inter = line_intersections(lines, ox, oy, w, h, config)
        xy, mask = inter.xy.cpu().numpy(), inter.valid.cpu().numpy()
        return [tuple(map(float, p)) for p in xy[mask]]


class ICP:
    """Reference ``ICP``: point-to-point ICP (on a card, the nearest
    neighbours are the ICP kernel)."""

    @staticmethod
    def get_transformation(source_points: np.ndarray, target_points: np.ndarray,
                           max_iterations: int = 100, threshold: float = 1e-5,
                           device: torch.device | str = "cuda"
                           ) -> Tuple[np.ndarray, np.ndarray]:
        cfg = DEFAULT_CONFIG.replace(icp_max_iterations=max_iterations,
                                     icp_tolerance=threshold)
        src, tgt = _points(source_points, device), _points(target_points, device)
        ones = lambda t: torch.ones(t.shape[0], dtype=torch.bool, device=t.device)
        res = _icp.icp(src, tgt, ones(src), ones(tgt), cfg)
        return res.rotation.cpu().numpy(), res.translation.cpu().numpy()


class GeometryUtils:
    """Reference ``GeometryUtils``."""

    @staticmethod
    def mahalanobis_distance(position_a, position_b, covariance_matrix) -> float:
        a = np.asarray(position_a, float)
        b = np.asarray(position_b, float)
        delta = b - a
        return float(np.sqrt(delta @ np.linalg.inv(np.asarray(covariance_matrix)) @ delta))

    @staticmethod
    def cluster_points(point_lists, eps: float, min_samples: int,
                       device: torch.device | str = "cuda") -> List[Tuple[float, float]]:
        pts = _points(point_lists, device)
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
        if min_samples <= 1:
            cl = _clustering.connected_component_clusters(pts, valid, eps)
        else:
            cl = _clustering.dbscan_clusters(pts, valid, eps, int(min_samples))
        cents, rep = cl.centroid.cpu().numpy(), cl.is_rep.cpu().numpy()
        return [tuple(map(float, c)) for c in cents[rep]]

    @staticmethod
    def calculate_distance_and_angle(x: float, y: float) -> Tuple[float, float]:
        return float(np.hypot(x, y)), float(np.arctan2(y, x))


class LandmarkUtils:
    """Reference ``LandmarkUtils``."""

    known_landmarks: List[Landmark] = []

    @classmethod
    def get_measurements_to_landmarks(cls, scanned_points: np.ndarray,
                                      config: FastSLAMConfig = DEFAULT_CONFIG,
                                      device: torch.device | str = "cuda"
                                      ) -> List[Measurement]:
        """Scan points -> corner measurements (the first ``num_beams``)."""
        n = scanned_points.shape[0]
        pts = np.zeros((config.num_beams, 2), np.float32)
        valid = np.zeros(config.num_beams, bool)
        m = min(n, config.num_beams)
        pts[:m] = scanned_points[:m]
        valid[:m] = True
        ms = _pipeline.scan_to_measurements(torch.from_numpy(pts).to(device),
                                            torch.from_numpy(valid).to(device), config)
        rb, mask = ms.range_bearing.cpu().numpy(), ms.valid.cpu().numpy()
        return [Measurement(float(d), float(b)) for d, b in rb[mask]]

    @staticmethod
    def associate_landmarks(observed_landmark: Landmark,
                            particle_landmarks: List[Landmark],
                            gate: float = DEFAULT_CONFIG.max_landmark_distance,
                            ) -> Tuple[Optional[Landmark], Optional[int]]:
        """The first landmark within the Mahalanobis gate, and its index."""
        obs = observed_landmark.as_vector()
        for i, lm in enumerate(particle_landmarks):
            d = GeometryUtils.mahalanobis_distance(lm.as_vector(), obs, lm.cov)
            if d < gate:
                return lm, i
        return None, None

    @classmethod
    def update_known_landmarks(cls, slam: FastSLAM2) -> None:
        """Re-cluster the particles' landmarks into the global map."""
        cents, ok = cluster_known_landmarks(slam.state, slam.config)
        cents, ok = cents.cpu().numpy(), ok.cpu().numpy()
        cls.known_landmarks = [Landmark(float(x), float(y)) for x, y in cents[ok]]
