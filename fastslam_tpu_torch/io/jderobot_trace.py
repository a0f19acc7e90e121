"""JdeRobot HAL traces: record and load the reference's native laser-data
shape (numpy and json; counterpart of ``fastslam_tpu/io/jderobot_trace.py``).

The reference reads its sensors only through the JdeRobot ``HAL`` surface:
``HAL.getLaserData()`` -> ``.values`` (180 ranges), ``.minRange``,
``.maxRange``, ``.timeStamp``; ``HAL.getPose3d()`` -> ``.x/.y/.yaw``;
``HAL.getBumperData()`` -> ``.state/.bumper``.  A trace is a JSONL file of
per-tick HAL records:

* :func:`record_hal_trace` records one from any live ``HAL`` (the
  simulator, or :class:`~fastslam_tpu_torch.drivers.jderobot_hal.SimHAL`);
* :func:`load_hal_trace` loads one as a
  :class:`~fastslam_tpu_torch.drivers.replay.LaserLog`, which replays
  through :class:`~fastslam_tpu_torch.drivers.replay.ReplayDriver` and
  ``run_driver`` with the reference's scan conversion (beam ``i`` at
  ``radians(i - 90)``, ranges outside ``[minRange, maxRange]`` gated out)
  and odometry (``dt`` from consecutive laser ``timeStamp`` values,
  ``rotation = w*dt`` XOR ``translation = v*dt*0.6``).

Trace schema (one JSON object per line)::

    {"laserData": {"values": [...], "minRange": 0.06, "maxRange": 10.0,
                   "timeStamp": 12.345},
     "pose3d": {"x": 0.0, "y": 0.0, "yaw": 0.0},
     "bumper": {"state": 0, "bumper": 0},
     "cmd": {"v": 0.3, "w": 0.5}}

``pose3d`` is the simulator's ground truth (for the ATE only, never read by
the filter); ``cmd`` the velocity the loop commanded that tick.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from fastslam_tpu_torch.drivers.replay import LaserLog


def record_hal_trace(path: str, hal, num_ticks: int, *, v_cmd: float = 0.3,
                     w_cmd: float = 0.5, drive: bool = True) -> int:
    """Drive ``hal`` (live or fake) with the reference's control policy and
    write one JSONL record per tick; returns the ticks written.

    ``drive=True`` runs the bumper-reactive move: rotate away from the
    pressed side while the bumper is hit, else drive straight at ``v_cmd``.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = 0
    with open(path, "w") as f:
        for _ in range(num_ticks):
            laser = hal.getLaserData()
            pose = hal.getPose3d()
            bumper = hal.getBumperData()
            if int(bumper.state) == 1:
                v = 0.0
                w = w_cmd if int(bumper.bumper) == 0 else -w_cmd
            else:
                v, w = v_cmd, 0.0
            if drive:
                hal.setV(float(v))
                hal.setW(float(w))
            rec = {
                "laserData": {
                    "values": np.asarray(laser.values, np.float64).round(6).tolist(),
                    "minRange": float(laser.minRange),
                    "maxRange": float(laser.maxRange),
                    "timeStamp": float(laser.timeStamp),
                },
                "pose3d": {"x": float(pose.x), "y": float(pose.y), "yaw": float(pose.yaw)},
                "bumper": {"state": int(bumper.state), "bumper": int(bumper.bumper)},
                "cmd": {"v": float(v), "w": float(w)},
            }
            f.write(json.dumps(rec) + "\n")
            n += 1
            if hasattr(hal, "step"):
                hal.step()  # fake HALs advance explicitly; live ones free-run
    return n


def load_hal_trace(path: str, *, num_beams: Optional[int] = None) -> LaserLog:
    """Parse a JdeRobot HAL JSONL trace into a :class:`LaserLog`: the raw
    HAL ranges, the commanded velocities, the laser time stamps, the bumper
    stream and the ground-truth poses.  Rows of another beam count than
    ``num_beams`` are padded with an out-of-range value or truncated; without
    ``num_beams`` every row must have the same count."""
    values_rows, stamps, cmd_v, cmd_w, b_state, b_id, gt = [], [], [], [], [], [], []
    min_range = max_range = None
    with open(path) as f:
        for line_no, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{line_no + 1}: not a JSON record: {e}") from e
            laser = rec["laserData"]
            row = np.asarray(laser["values"], np.float32)
            if num_beams is not None and row.shape[0] != num_beams:
                out = np.full(num_beams, float(laser["maxRange"]) + 1.0, np.float32)
                out[:min(row.shape[0], num_beams)] = row[:num_beams]
                row = out
            values_rows.append(row)
            if min_range is None:
                min_range = float(laser["minRange"])
                max_range = float(laser["maxRange"])
            stamps.append(float(laser["timeStamp"]))
            cmd = rec.get("cmd", {})
            cmd_v.append(float(cmd.get("v", 0.0)))
            cmd_w.append(float(cmd.get("w", 0.0)))
            bumper = rec.get("bumper", {})
            b_state.append(int(bumper.get("state", 0)))
            b_id.append(int(bumper.get("bumper", 0)))
            pose = rec.get("pose3d", {})
            gt.append([float(pose.get("x", 0.0)), float(pose.get("y", 0.0)),
                       float(pose.get("yaw", 0.0))])
    if not values_rows:
        raise ValueError(f"{path}: empty trace")
    widths = {r.shape[0] for r in values_rows}
    if len(widths) != 1:
        raise ValueError(f"{path}: inconsistent beam counts {sorted(widths)}; pass "
                         "num_beams= to pad/truncate")
    return LaserLog(
        scans=np.stack(values_rows), min_range=min_range, max_range=max_range,
        timestamps=np.asarray(stamps, np.float64),
        cmd_v=np.asarray(cmd_v, np.float32), cmd_w=np.asarray(cmd_w, np.float32),
        bumper_state=np.asarray(b_state, np.int32), bumper_id=np.asarray(b_id, np.int32),
        gt_poses=np.asarray(gt, np.float64),
    )
