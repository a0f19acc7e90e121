"""NumPy oracle: a direct transcription of the reference FastSLAM equations.

The port's own copy of the JAX package's test oracle (the same functions,
the same arithmetic, the same quirks), so that the port's accuracy matrix
(:mod:`fastslam_tpu_torch.eval.suite`) carries its reference baseline with
it.  Written from the reference's ``fast_slam_2/algorithms/fast_slam_2.py``,
``utils/landmark_utils.py:92-117`` and ``utils/geometry_utils.py:14-23``
with the noise draws injected, object-free, array of structures, and every
quirk kept: the robot-frame association, the first landmark under the gate,
weights kept after resampling, the <1e-5 normalization skip, the
argmax-weight pose.  It is not a production path.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class OracleLandmark:
    x: float
    y: float
    cov: np.ndarray = field(
        default_factory=lambda: np.array([[0.1, 0.0], [0.0, 0.1]])
    )


@dataclass
class OracleParticle:
    x: float
    y: float
    yaw: float
    weight: float
    landmarks: List[OracleLandmark] = field(default_factory=list)


def make_particles(n: int) -> List[OracleParticle]:
    # fast_slam_2.py:25-31 + particle.py:19: origin poses, weight 1/N
    return [OracleParticle(0.0, 0.0, 0.0, 1.0 / n) for _ in range(n)]


def wrap(a: float) -> float:
    return (a + np.pi) % (2 * np.pi) - np.pi


def move_particle(p: OracleParticle, rotation: float, translation: float,
                  rot_noise: float, trans_noise: float) -> None:
    # fast_slam_2.py:69-87 with the noise draw injected
    if rotation != 0:
        noisy_t, noisy_r = 0.0, rotation + rot_noise
    else:
        noisy_t, noisy_r = translation + trans_noise, 0.0
    p.yaw = wrap(p.yaw + noisy_r)
    p.x += noisy_t * math.cos(p.yaw)
    p.y += noisy_t * math.sin(p.yaw)


def mahalanobis(a: np.ndarray, b: np.ndarray, cov: np.ndarray) -> float:
    # geometry_utils.py:14-23
    delta = b - a
    return float(np.sqrt(delta.T @ np.linalg.inv(cov) @ delta))


def associate_first_match(
    obs: np.ndarray, landmarks: List[OracleLandmark], gate: float
) -> Optional[int]:
    # landmark_utils.py:92-117: first landmark under the gate, scan order
    for i, lm in enumerate(landmarks):
        if mahalanobis(np.array([lm.x, lm.y]), obs, lm.cov) < gate:
            return i
    return None


def update_particle(
    p: OracleParticle,
    dist: float,
    bearing: float,
    meas_noise: float = 0.001,
    gate: float = 8.0,
) -> None:
    # fast_slam_2.py:89-159, with the robot-frame association quirk kept
    obs = np.array([dist * np.cos(bearing), dist * np.sin(bearing)])
    j = associate_first_match(obs, p.landmarks, gate)
    if j is None:
        lx = p.x + dist * math.cos(p.yaw + bearing)
        ly = p.y + dist * math.sin(p.yaw + bearing)
        p.landmarks.append(OracleLandmark(lx, ly))
        return

    lm = p.landmarks[j]
    dx, dy = lm.x - p.x, lm.y - p.y
    q = dx * dx + dy * dy
    r = math.sqrt(q)
    pred = np.array([r, np.arctan2(dy, dx) - p.yaw])
    nu = np.array([dist, bearing]) - pred
    nu[1] = wrap(nu[1])
    h = np.array([[dx / r, dy / r], [-dy / q, dx / q]])
    s = h @ lm.cov @ h.T + meas_noise * np.eye(2)
    k = lm.cov @ h.T @ np.linalg.inv(s)
    mean = np.array([lm.x, lm.y]) + k @ nu
    cov = (np.eye(2) - k @ h) @ lm.cov
    p.landmarks[j] = OracleLandmark(float(mean[0]), float(mean[1]), cov)
    # scipy.stats.multivariate_normal.pdf(nu, 0, s), written out
    det = np.linalg.det(s)
    lik = math.exp(-0.5 * float(nu @ np.linalg.inv(s) @ nu)) / (
        2 * np.pi * math.sqrt(det)
    )
    p.weight *= lik


def normalize_weights(particles: List[OracleParticle]) -> None:
    # fast_slam_2.py:161-175, incl. the <1e-5 skip quirk
    total = sum(p.weight for p in particles)
    n = len(particles)
    if total < 1e-5:
        for p in particles:
            p.weight = 1.0 / n
    else:
        for p in particles:
            p.weight = p.weight if p.weight < 1e-5 else p.weight / total


def effective_particles(particles: List[OracleParticle]) -> float:
    # fast_slam_2.py:212-223
    n = len(particles)
    s = sum(p.weight ** 2 for p in particles)
    if s < 1.0 / n:
        return float(n)
    return 1.0 / s


def systematic_resample(particles: List[OracleParticle], u0: float) -> List[int]:
    # fast_slam_2.py:177-199: ancestor indices instead of deep copies
    n = len(particles)
    out = []
    weight = particles[0].weight
    index = 0
    for m in range(n):
        u = u0 + m / n
        while u > weight:
            index = min(index + 1, n - 1)
            weight += particles[index].weight
        out.append(index)
    return out


def estimate_pose(particles: List[OracleParticle]) -> Tuple[float, float, float]:
    # fast_slam_2.py:201-210: the argmax-weight particle
    best = max(particles, key=lambda p: p.weight)
    return best.x, best.y, best.yaw


def iterate(
    particles: List[OracleParticle],
    rotation: float,
    translation: float,
    measurements: List[Tuple[float, float]],
    rot_noise: np.ndarray,
    trans_noise: np.ndarray,
    u0: float,
) -> Tuple[float, float, float]:
    """One oracle iteration, the reference's ``FastSLAM2.iterate`` with the
    noise injected.  Mutates ``particles`` in place (a resample replaces the
    list's contents)."""
    n = len(particles)
    for i, p in enumerate(particles):
        move_particle(p, rotation, translation, float(rot_noise[i]), float(trans_noise[i]))
    for dist, bearing in measurements:
        for p in particles:
            update_particle(p, dist, bearing)
    normalize_weights(particles)
    neff = effective_particles(particles)
    if neff < n / 2:
        idx = systematic_resample(particles, u0)
        particles[:] = [copy.deepcopy(particles[i]) for i in idx]
    return estimate_pose(particles)
