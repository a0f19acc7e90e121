"""Filter -> backend integration: pose-graph smoothing of a SLAM run.

Counterpart of ``fastslam_tpu/backend/integration.py``.  Takes a replay log
plus the filter's estimated trajectory, subsamples keyframes, re-extracts
corner measurements at each keyframe with the frontend, builds the pose
graph, and optimizes: the filter's argmax-particle estimate drifts, and the
smoother pulls it back onto the loop closures.  The frontend, the tracker
and the optimizer run on ``device`` (the card unless the caller passes
another); graph construction is host numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fastslam_tpu_torch.backend.builder import (
    build_pose_graph,
    reassociate_pose_graph,
    reinit_landmarks,
)
from fastslam_tpu_torch.backend.pose_graph import optimize
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.drivers.base import LaserScan
from fastslam_tpu_torch.drivers.replay import LaserLog
from fastslam_tpu_torch.frontend.pipeline import extract_corners, scan_to_measurements
from fastslam_tpu_torch.frontend.tracking import init_tracks, stable_corners, update_tracks


def _scan(log: LaserLog, t: int, device) -> Tuple[torch.Tensor, torch.Tensor, float]:
    scan = LaserScan(values=log.scans[t], min_range=log.min_range,
                     max_range=log.max_range, timestamp=float(log.timestamps[t]))
    pts, valid = scan.to_points()
    return (torch.from_numpy(pts).to(device), torch.from_numpy(valid).to(device),
            scan.timestamp)


def extract_keyframe_measurements(log: LaserLog, keyframe_ticks: np.ndarray,
                                  config: FastSLAMConfig,
                                  device: torch.device | str = "cuda"):
    """Run the frontend on each keyframe's scan; returns a list of
    [m_k, 2] (range, bearing) arrays."""
    out = []
    for t in keyframe_ticks:
        pts, valid, _ = _scan(log, int(t), device)
        ms = scan_to_measurements(pts, valid, config)
        out.append(ms.range_bearing[ms.valid].cpu().numpy())
    return out


def extract_tracked_keyframe_measurements(log: LaserLog, keyframe_ticks: np.ndarray,
                                          config: FastSLAMConfig,
                                          device: torch.device | str = "cuda"):
    """Run the corner identity tracker over EVERY tick of the log and emit
    (measurements, track_ids) at the keyframes.

    The tracker establishes corner identity frame-to-frame, when inter-frame
    drift is tiny, so the ids are valid loop-closure identities even where
    the trajectory estimate has drifted far beyond any world-frame
    association gate.  Odometry for ego-compensation is reconstructed from
    the log's commanded velocities exactly as the runner does (previous
    commands paired with the current laser dt, rotation XOR translation,
    velocity fudge).
    """
    tracks = init_tracks(config.track_capacity, device)
    kf_set = set(int(t) for t in keyframe_ticks)
    out_ms, out_ids = {}, {}
    prev_ts = None
    prev_cmd = (0.0, 0.0)
    for t in range(len(log)):
        pts, valid, ts = _scan(log, t, device)
        v, w = prev_cmd
        prev_cmd = (float(log.cmd_v[t]), float(log.cmd_w[t]))
        dt = 0.0 if prev_ts is None else ts - prev_ts
        prev_ts = ts
        if v != 0.0:
            rot, trans = 0.0, v * dt * config.velocity_fudge
        else:
            rot, trans = w * dt, 0.0

        corners, cvalid = extract_corners(pts, valid, config)
        tracks = update_tracks(tracks, corners, cvalid,
                               torch.tensor(rot, dtype=torch.float32, device=device),
                               torch.tensor(trans, dtype=torch.float32, device=device),
                               gate=config.track_gate, ema=config.track_ema,
                               max_misses=config.track_max_misses)
        if t in kf_set:
            pos, ids, ok = stable_corners(tracks, min_hits=config.track_min_hits)
            p = pos[ok].cpu().numpy()
            rb = np.stack(
                [np.hypot(p[:, 0], p[:, 1]), np.arctan2(p[:, 1], p[:, 0])], axis=-1,
            ) if len(p) else np.zeros((0, 2))
            out_ms[t] = rb
            out_ids[t] = ids[ok].cpu().numpy()
    return ([out_ms[int(t)] for t in keyframe_ticks],
            [out_ids[int(t)] for t in keyframe_ticks])


def smooth_trajectory(
    log: LaserLog,
    est_poses: np.ndarray,
    config: FastSLAMConfig,
    *,
    keyframe_stride: int = 10,
    num_iters: int = 15,
    max_landmarks: int = 64,
    max_factors: int = 1024,
    association_gate: float = 0.8,
    reassociate_rounds: int = 3,
    use_tracking: bool = False,
    device: torch.device | str = "cuda",
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Pose-graph smoothing over keyframes of a finished run.

    Args:
      log: the replayed laser log.
      est_poses: ``[T, 3]`` filter trajectory.
      device: where the frontend, tracker and optimizer run.

    Returns (smoothed_keyframe_poses [K, 3], keyframe_ticks [K], info).
    """
    t_total = min(len(log), len(est_poses))
    ticks = np.arange(0, t_total, keyframe_stride)
    kf_poses = np.asarray(est_poses)[ticks]

    if use_tracking:
        # persistent tracker ids as landmark identities: the refinement
        # rounds below re-initialize landmark POSITIONS only
        measurements, ids = extract_tracked_keyframe_measurements(log, ticks, config, device)
    else:
        measurements = extract_keyframe_measurements(log, ticks, config, device)
        ids = None
    graph = build_pose_graph(
        kf_poses, measurements, measurement_ids=ids,
        association_gate=association_gate,
        max_landmarks=max_landmarks, max_factors=max_factors, device=device,
    )
    poses, landmarks, err, hist = optimize(graph, num_iters=num_iters)

    # joint re-association: redo data association from the optimized poses
    # and re-optimize; accept a round only if the per-factor error improves
    # (factor counts can differ between graphs)
    rounds_used = 0
    per_factor = lambda e, g: float(e) / max(int(g.obs_valid.sum()), 1)
    for _ in range(reassociate_rounds):
        if use_tracking:
            g2 = reinit_landmarks(graph, poses)
        else:
            g2 = reassociate_pose_graph(graph, poses, association_gate=association_gate)
        p2, l2, e2, h2 = optimize(g2, num_iters=num_iters)
        if per_factor(e2, g2) < per_factor(err, graph):
            graph, poses, landmarks, err, hist = g2, p2, l2, e2, h2
            rounds_used += 1
        else:
            break

    info = {
        "final_error": float(err),
        "num_keyframes": len(ticks),
        "num_landmarks": int(graph.lm_valid.sum()),
        "num_factors": int(graph.obs_valid.sum()),
        "reassociation_rounds": rounds_used,
    }
    return poses.cpu().numpy(), ticks, info
