"""Log recording and deterministic replay (numpy copy of
``fastslam_tpu/drivers/replay.py``).

The reference has no replay capability — every run needs the live Gazebo
simulator.  Here any :class:`Driver` run can be recorded to a compact ``.npz``
log (scans, commanded velocities, bumper states, timestamps, ground-truth
poses) and replayed bit-identically, which is what both CI and the ATE
benchmark consume.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from fastslam_tpu_torch.drivers.base import BumperState, Driver, LaserScan, Pose


@dataclass
class LaserLog:
    """Columnar tick log."""

    scans: np.ndarray        # [T, B] ranges
    min_range: float
    max_range: float
    timestamps: np.ndarray   # [T]
    cmd_v: np.ndarray        # [T] commanded linear velocity
    cmd_w: np.ndarray        # [T] commanded angular velocity
    bumper_state: np.ndarray # [T] int
    bumper_id: np.ndarray    # [T] int
    gt_poses: np.ndarray     # [T, 3] ground truth (x, y, yaw)

    def __len__(self) -> int:
        return self.scans.shape[0]

    def save(self, path: str) -> None:
        """Save as .fslog (the FSLG1 codec, ``io/native_log.py``) or .npz,
        by extension."""
        if path.endswith(".fslog"):
            from fastslam_tpu_torch.io.native_log import write_log

            write_log(path, self)
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(
            path,
            scans=self.scans,
            min_range=self.min_range,
            max_range=self.max_range,
            timestamps=self.timestamps,
            cmd_v=self.cmd_v,
            cmd_w=self.cmd_w,
            bumper_state=self.bumper_state,
            bumper_id=self.bumper_id,
            gt_poses=self.gt_poses,
        )

    @staticmethod
    def load(path: str) -> "LaserLog":
        if path.endswith(".fslog"):
            from fastslam_tpu_torch.io.native_log import read_log

            return read_log(path)
        z = np.load(path)
        return LaserLog(
            scans=z["scans"],
            min_range=float(z["min_range"]),
            max_range=float(z["max_range"]),
            timestamps=z["timestamps"],
            cmd_v=z["cmd_v"],
            cmd_w=z["cmd_w"],
            bumper_state=z["bumper_state"],
            bumper_id=z["bumper_id"],
            gt_poses=z["gt_poses"],
        )


def record_log(world, num_ticks: int, v_cmd: float = 0.3, w_cmd: float = 0.5) -> LaserLog:
    """Drive ``world`` with the reference's bumper-reactive policy and record.

    Policy from ``robot.py:61-88`` + ``jde_robots_main.py:25``: drive straight
    at ``v_cmd``; on bumper contact stop and rotate (direction depends on
    which bumper hit) until free.
    """
    scans, ts, vs, ws, bst, bid, gts = [], [], [], [], [], [], []
    for _ in range(num_ticks):
        bumper = world.get_bumper()
        if bumper.state == 1:
            v = 0.0
            w = w_cmd if bumper.bumper == 0 else -w_cmd
        else:
            v, w = v_cmd, 0.0
        world.set_velocity(v, w)

        scan = world.get_laser()
        pose = world.get_pose()
        scans.append(scan.values)
        ts.append(scan.timestamp)
        vs.append(v)
        ws.append(w)
        bst.append(bumper.state)
        bid.append(bumper.bumper)
        gts.append([pose.x, pose.y, pose.yaw])
        world.step()

    return LaserLog(
        scans=np.asarray(scans),
        min_range=world.min_range,
        max_range=world.max_range,
        timestamps=np.asarray(ts),
        cmd_v=np.asarray(vs),
        cmd_w=np.asarray(ws),
        bumper_state=np.asarray(bst, np.int32),
        bumper_id=np.asarray(bid, np.int32),
        gt_poses=np.asarray(gts),
    )


@dataclass
class ReplayDriver:
    """Replays a :class:`LaserLog` through the :class:`Driver` protocol."""

    log: LaserLog
    _tick: int = 0

    def get_laser(self) -> LaserScan:
        t = min(self._tick, len(self.log) - 1)
        return LaserScan(
            values=self.log.scans[t],
            min_range=self.log.min_range,
            max_range=self.log.max_range,
            timestamp=float(self.log.timestamps[t]),
        )

    def get_pose(self) -> Pose:
        t = min(self._tick, len(self.log) - 1)
        x, y, yaw = self.log.gt_poses[t]
        return Pose(float(x), float(y), float(yaw))

    def get_bumper(self) -> BumperState:
        t = min(self._tick, len(self.log) - 1)
        return BumperState(int(self.log.bumper_state[t]), int(self.log.bumper_id[t]))

    def commanded_velocity(self) -> tuple:
        t = min(self._tick, len(self.log) - 1)
        return float(self.log.cmd_v[t]), float(self.log.cmd_w[t])

    def set_velocity(self, v: float, w: float) -> None:
        pass  # replay ignores commands

    def step(self) -> bool:
        self._tick += 1
        return self._tick < len(self.log)
