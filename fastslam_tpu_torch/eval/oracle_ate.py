"""The reference implementation's ATE on a replay log, and the engine's beside it.

The reference publishes no numbers, so its accuracy baseline is established
by replaying its exact equations (:mod:`fastslam_tpu_torch.eval.oracle`)
over the same logs the engine consumes: the oracle gets the engine's
frontend measurements (``frontend.pipeline.scan_to_measurements`` on
``device``) and the same command odometry.

    python -m fastslam_tpu_torch.eval.oracle_ate [--log runs/log.npz] \\
        [--ticks 300] [--particles 100] [--warmup 150] [--seed 3] [--device cpu]

prints one JSON line: the oracle's ATE beside the engine's (parity and
production modes of ``run_driver``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.drivers.base import LaserScan
from fastslam_tpu_torch.eval import oracle
from fastslam_tpu_torch.frontend.pipeline import scan_to_measurements


def check_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device without a card
    raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) "
                               "to run on the CPU")
        # the frontend's float32 products must not drop to TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def start_frame(gt_poses: np.ndarray) -> np.ndarray:
    """Ground truth in the frame of its first pose (full SE(2) alignment)."""
    p0 = gt_poses[0]
    c0, s0 = np.cos(-p0[2]), np.sin(-p0[2])
    d = gt_poses - p0
    return np.stack([c0 * d[:, 0] - s0 * d[:, 1],
                     s0 * d[:, 0] + c0 * d[:, 1],
                     d[:, 2]], axis=-1)


def oracle_odometry(log, cfg: FastSLAMConfig, odometry_noise=(0.0, 0.0),
                    odometry_noise_seed: int = 123):
    """The ``[T]`` (rotation, translation) odometry :func:`run_oracle` feeds
    the reference equations: the command of the same tick (the reference's
    command/laser pairing), rotation XOR translation with the velocity fudge
    on translation, and ``odometry_noise`` = (rotation, translation)
    std-devs of wheel slip, one draw from ``odometry_noise_seed`` per tick
    on its active component."""
    odo_rng = np.random.default_rng(odometry_noise_seed)
    rots, trans = np.zeros(len(log)), np.zeros(len(log))
    prev_ts = None
    for t in range(len(log)):
        v, w = float(log.cmd_v[t]), float(log.cmd_w[t])
        ts = float(log.timestamps[t])
        dt = 0.0 if prev_ts is None else ts - prev_ts
        prev_ts = ts
        if v != 0:
            rotation, translation = 0.0, v * dt * cfg.velocity_fudge
        else:
            rotation, translation = w * dt, 0.0
        if odometry_noise != (0.0, 0.0):
            if rotation != 0.0:
                rotation += odo_rng.normal(0.0, odometry_noise[0])
            if translation != 0.0:
                translation += odo_rng.normal(0.0, odometry_noise[1])
        rots[t], trans[t] = rotation, translation
    return rots, trans


def run_oracle(log, cfg: FastSLAMConfig, seed: int = 0, odometry_noise=(0.0, 0.0),
               odometry_noise_seed: int = 123, *, device="cuda") -> np.ndarray:
    """Replay the reference equations over ``log``; returns the ``[T, 3]``
    estimates.

    ``seed`` seeds the numpy generator of the particles' motion noise and
    the resample offset.  ``odometry_noise`` corrupts the (rotation,
    translation) odometry the filter sees as ``run_driver`` does
    (per-component gaussian, only on active ticks, from
    ``odometry_noise_seed``; :func:`oracle_odometry`).  Where every tick
    after the first has one active component on both sides, as on the
    accuracy matrix's logs, oracle and engine get the same draw on the same
    tick; their odometry parts only where the oracle's command/laser
    pairing (the reference's: the command of the same tick) differs from
    the engine's (the previous tick's command), on the ticks where the
    command changes.  During the first ``cfg.warmup_iterations`` ticks the
    estimate is dead reckoning, as the reference's control loop does.
    """
    device = check_device(device)
    rng = np.random.default_rng(seed)
    rots, trans = oracle_odometry(log, cfg, odometry_noise, odometry_noise_seed)

    particles = oracle.make_particles(cfg.num_particles)
    robot = np.zeros(3)
    est = []
    for t in range(len(log)):
        scan = LaserScan(log.scans[t], log.min_range, log.max_range,
                         float(log.timestamps[t]))
        pts, valid = scan.to_points()
        rotation, translation = float(rots[t]), float(trans[t])

        ms = scan_to_measurements(torch.from_numpy(pts).to(device),
                                  torch.from_numpy(valid).to(device), cfg)
        mask = ms.valid.cpu().numpy()
        rb = [tuple(map(float, m)) for m in ms.range_bearing.cpu().numpy()[mask]]

        rot_noise = rng.normal(0, cfg.rotation_noise, cfg.num_particles)
        trans_noise = rng.normal(0, cfg.translation_noise, cfg.num_particles)
        u0 = float(rng.uniform(0, 1.0 / cfg.num_particles))
        pose = oracle.iterate(particles, rotation, translation, rb,
                              rot_noise, trans_noise, u0)

        if t < cfg.warmup_iterations:
            robot[2] = (robot[2] + rotation + np.pi) % (2 * np.pi) - np.pi
            robot[0] += translation * np.cos(robot[2])
            robot[1] += translation * np.sin(robot[2])
        else:
            robot = np.asarray(pose, float).copy()
        est.append(robot.copy())
    return np.asarray(est)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fastslam_tpu_torch.eval.oracle_ate")
    ap.add_argument("--log", default=None, help="replay log (.npz); default: record fresh")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--particles", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=150)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from fastslam_tpu_torch.app.runner import run_driver
    from fastslam_tpu_torch.drivers.replay import LaserLog, ReplayDriver, record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld
    from fastslam_tpu_torch.eval.metrics import ate_rmse

    device = check_device(args.device)
    if args.log:
        log = LaserLog.load(args.log)
    else:
        log = record_log(SimWorld(seed=args.seed), num_ticks=args.ticks)

    cfg = FastSLAMConfig(num_particles=args.particles, max_landmarks=64,
                         warmup_iterations=args.warmup)
    gt = start_frame(log.gt_poses)

    oracle_est = run_oracle(log, cfg, seed=0, device=device)
    results = {"oracle_ate_m": round(ate_rmse(gt[:, :2], oracle_est[:, :2]), 4),
               "ticks": len(log), "particles": args.particles}
    for label, overrides in [
        ("engine_parity_ate_m", {}),
        ("engine_production_ate_m", {"parity_mode": False}),
    ]:
        hist = run_driver(ReplayDriver(log), cfg.replace(**overrides), rng=0,
                          device=device)
        est = np.asarray(hist.est_poses)
        results[label] = round(ate_rmse(gt[:, :2], est[:, :2]), 4)
    results["device"] = str(device)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
