"""Tick serialization, JSON-schema-compatible with the reference viewer.

A copy of ``fastslam_tpu/io/serializer.py`` (numpy), so the viewer that
reads the JAX package's snapshots reads the port's.  The reference writes
``{estimated_robot_pos, actual_robot_pos, particles, landmarks, results}``
to ``workspace/shared/fast_slam.json`` every tick and a separate process
polls it.  Writes are atomic (write a temporary file, then rename), so the
polling reader never sees a torn file; :class:`TrajectoryLogger` appends a
JSONL trajectory log for offline analysis.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Iterable, Optional

import numpy as np


def _pose_dict(pose) -> dict:
    x, y, yaw = (float(v) for v in np.asarray(pose).reshape(3))
    return {"x": x, "y": y, "yaw": yaw}


def _point_dict(point) -> dict:
    x, y = (float(v) for v in np.asarray(point).reshape(2))
    return {"x": x, "y": y}


def serialize_tick(
    estimated_pose,
    actual_pose,
    particle_poses: np.ndarray,
    landmarks: Iterable,
    results: Optional[dict],
    path: str = "workspace/shared/fast_slam.json",
    max_particles: int = 500,
) -> None:
    """Write one tick snapshot atomically.

    Args:
      estimated_pose/actual_pose: (x, y, yaw).
      particle_poses: ``[P, 3]`` — subsampled to ``max_particles`` for the
        viewer (the reference serializes all 20; we may have 100k).
      landmarks: iterable of (x, y) clustered global landmarks.
      results: evaluation dict (see ``TickEvaluation.to_dict``), or None.
    """
    poses = np.asarray(particle_poses)
    if poses.shape[0] > max_particles:
        idx = np.linspace(0, poses.shape[0] - 1, max_particles).astype(int)
        poses = poses[idx]

    payload = {
        "estimated_robot_pos": _pose_dict(estimated_pose),
        "actual_robot_pos": _pose_dict(actual_pose),
        "particles": [_pose_dict(p) for p in poses],
        "landmarks": [_point_dict(lm) for lm in landmarks],
        "results": results or {},
    }

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=4)
        os.replace(tmp, path)  # atomic on POSIX
    except BaseException:
        os.unlink(tmp)
        raise


def deserialize_tick(path: str):
    """Read a tick snapshot; tolerant of missing files (returns None), matching
    ``landmark_map/utils/deserializer.py:23-33`` behaviour."""
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            data = json.load(f)
    except (json.JSONDecodeError, OSError):
        return None
    est = data["estimated_robot_pos"]
    act = data["actual_robot_pos"]
    return {
        "estimated_robot_pos": (est["x"], est["y"], est["yaw"]),
        "actual_robot_pos": (act["x"], act["y"], act["yaw"]),
        "particles": [(p["x"], p["y"], p["yaw"]) for p in data["particles"]],
        "landmarks": [(l["x"], l["y"]) for l in data["landmarks"]],
        "results": data.get("results", {}),
    }


class TrajectoryLogger:
    """Append-mode JSONL logger: one line per tick, machine-readable."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")

    def log(self, tick: int, estimated_pose, actual_pose, extra: Optional[dict] = None):
        rec = {
            "tick": tick,
            "est": [float(v) for v in np.asarray(estimated_pose).reshape(3)],
            "gt": [float(v) for v in np.asarray(actual_pose).reshape(3)],
        }
        if extra:
            rec.update(extra)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
