"""Offline batch replay of a recorded log through the chunked engine.

Counterpart of ``RunHistory`` and ``replay_chunked`` of
``fastslam_tpu/app/runner.py`` (the motion-proposal path without ICP or
adaptive floors).  A recorded log has no feedback from the estimate to the
commands, so the frontend runs over every scan first, then the filter takes
``chunk_size`` ticks per call of the chunked update; the ``T mod chunk_size``
tail ticks go through the per-tick step.  Odometry pairing, the
dead-reckoning warmup and the ground-truth frame match the JAX runner.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import Measurements, init_planes_state
from fastslam_tpu_torch.eval.metrics import TickEvaluation, evaluate_tick, trajectory_metrics
from fastslam_tpu_torch.frontend.pipeline import scan_to_measurements


@dataclass
class RunHistory:
    est_poses: List[np.ndarray] = field(default_factory=list)
    gt_poses: List[np.ndarray] = field(default_factory=list)
    evaluations: List[TickEvaluation] = field(default_factory=list)
    num_measurements: List[int] = field(default_factory=list)

    def metrics(self, skip: int = 0) -> dict:
        return trajectory_metrics(
            np.asarray(self.gt_poses[skip:]), np.asarray(self.est_poses[skip:])
        )


def _check_supported(config: FastSLAMConfig) -> None:
    if config.parity_mode:
        raise ValueError("replay_chunked runs in production mode "
                         "(parity_mode=False)")
    if config.use_icp_proposal or config.adaptive_proposal_floors:
        raise NotImplementedError(
            "use_icp_proposal and adaptive_proposal_floors are not ported yet "
            "(ROADMAP.md: ICP and adaptive proposals)")
    if config.proposal_mode == "fastslam2":
        raise NotImplementedError("proposal_mode='fastslam2' is not ported yet "
                                  "(ROADMAP.md: fs2)")


def scan_points(log):
    """Polar scans ``[T, B]`` -> robot-frame points ``[T, B, 2]`` and validity."""
    values = np.asarray(log.scans, np.float32)
    n = values.shape[1]
    angles = np.radians(np.arange(n) - n // 2).astype(np.float32)
    valid = (values >= log.min_range) & (values <= log.max_range)
    pts = np.stack([values * np.cos(angles), values * np.sin(angles)], axis=-1)
    pts[~valid] = 0.0
    return pts, valid


def odometry(log, config: FastSLAMConfig):
    """Per-tick (rotation, translation) from the previous tick's commands,
    rotation XOR translation, with the velocity fudge on translation."""
    t_total = len(log)
    rots = np.zeros(t_total, np.float32)
    trans = np.zeros(t_total, np.float32)
    prev_ts = None
    prev_cmd = (0.0, 0.0)
    for t in range(t_total):
        v, w = prev_cmd
        prev_cmd = (float(log.cmd_v[t]), float(log.cmd_w[t]))
        ts = float(log.timestamps[t])
        dt = 0.0 if prev_ts is None else ts - prev_ts
        prev_ts = ts
        if v != 0:
            trans[t] = v * dt * config.velocity_fudge
        else:
            rots[t] = w * dt
    return rots, trans


def replay_chunked(log, config: FastSLAMConfig, chunk_size: int = 8,
                   rng: int = 0, *, device: torch.device | str = "cuda",
                   odometry_noise: tuple = (0.0, 0.0),
                   odometry_noise_seed: int = 123) -> RunHistory:
    """Replay ``log`` through the chunked engine on ``device``.

    ``rng`` seeds the :class:`torch.Generator` of the filter's draws.
    ``odometry_noise`` = (rotation, translation) std-devs of wheel slip added
    to what the filter sees, one draw per active component tick.
    """
    _check_supported(config)
    device = torch.device(device)
    t_total = len(log)
    c = chunk_size

    pts, valid = scan_points(log)
    pts_d = torch.from_numpy(pts).to(device)
    valid_d = torch.from_numpy(valid).to(device)
    ms = [scan_to_measurements(pts_d[t], valid_d[t], config) for t in range(t_total)]
    rb = torch.stack([m.range_bearing for m in ms])          # [T, M, 2]
    mv = torch.stack([m.valid for m in ms])                  # [T, M]

    rots, trans = odometry(log, config)
    if odometry_noise != (0.0, 0.0):
        odo_rng = np.random.default_rng(odometry_noise_seed)
        for t in range(t_total):
            if rots[t] != 0.0:
                rots[t] += odo_rng.normal(0.0, odometry_noise[0])
            if trans[t] != 0.0:
                trans[t] += odo_rng.normal(0.0, odometry_noise[1])
    rots_d = torch.from_numpy(rots).to(device)
    trans_d = torch.from_numpy(trans).to(device)

    generator = torch.Generator(device=device).manual_seed(rng)
    state = init_planes_state(config, device)
    p = config.num_particles
    n_chunks = t_total // c
    est = torch.zeros((t_total, 3), dtype=torch.float32, device=device)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        state, est[sl] = kernels.fastslam_steps_planes_chunked(
            state, rots_d[sl], trans_d[sl], Measurements(rb[sl], mv[sl]),
            config, kernels.draw(generator, p, c),
        )
    for t in range(n_chunks * c, t_total):
        state, est[t] = kernels.fastslam_step_planes(
            state, rots_d[t], trans_d[t], Measurements(rb[t], mv[t]), config,
            kernels.draw(generator, p),
        )
    est = est.cpu().numpy()

    # warmup gate: dead-reckon exactly as the online loop
    robot = np.zeros(3)
    for t in range(min(config.warmup_iterations, t_total)):
        robot[2] = (robot[2] + rots[t] + np.pi) % (2 * np.pi) - np.pi
        robot[0] += trans[t] * np.cos(robot[2])
        robot[1] += trans[t] * np.sin(robot[2])
        est[t] = robot

    # ground truth in the filter's start frame
    gts = np.asarray(log.gt_poses, np.float64)
    off = gts[0]
    c0, s0 = np.cos(-off[2]), np.sin(-off[2])
    dx, dy = gts[:, 0] - off[0], gts[:, 1] - off[1]
    gt = np.stack(
        [c0 * dx - s0 * dy, s0 * dx + c0 * dy,
         (gts[:, 2] - off[2] + np.pi) % (2 * np.pi) - np.pi], axis=-1,
    )

    history = RunHistory()
    history.est_poses = [e for e in est]
    history.gt_poses = [g for g in gt]
    history.num_measurements = [int(x) for x in mv.sum(dim=1).tolist()]
    for e, g in zip(est, gt):
        history.evaluations.append(evaluate_tick(g, e))
    return history
