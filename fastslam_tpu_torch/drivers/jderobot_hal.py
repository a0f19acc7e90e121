"""The live JdeRobot ``HAL`` bridge (counterpart of
``fastslam_tpu/drivers/jderobot_hal.py``).

The reference calls ``HAL.getLaserData()`` (``.values``, ``.minRange``,
``.maxRange``, ``.timeStamp``), ``HAL.getBumperData()`` (``.state``,
``.bumper``), ``HAL.getPose3d()`` (``.x``, ``.y``, ``.yaw``) and
``HAL.setV``/``HAL.setW``.  :class:`HALDriver` exposes exactly that surface
as a :class:`~fastslam_tpu_torch.drivers.base.Driver`, so inside the
JdeRobot web IDE the engine runs on the card with::

    import HAL
    from fastslam_tpu_torch import FastSLAMConfig, HALDriver, run_driver
    run_driver(HALDriver(HAL), FastSLAMConfig(num_particles=1024,
                                              parity_mode=False))

The ``hal`` argument is duck-typed; :class:`SimHAL` provides the same calls
over :class:`~fastslam_tpu_torch.drivers.sim_world.SimWorld`, for tests and
for recording traces without the simulator.  A live simulator advances on
wall-clock: ``step()`` optionally sleeps to hold a tick rate and never
reports exhaustion; the run ends by ``max_ticks`` or by the operator.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from fastslam_tpu_torch.drivers.base import BumperState, LaserScan, Pose


class SimHAL:
    """A duck-typed JdeRobot ``HAL`` over :class:`SimWorld`.  The world steps
    when the ``setW`` actuation lands: one sim tick per control tick."""

    class _Obj:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    def __init__(self, world):
        self._world = world
        self._v = 0.0

    def getLaserData(self):
        s = self._world.get_laser()
        return self._Obj(values=s.values, minRange=s.min_range, maxRange=s.max_range,
                         timeStamp=s.timestamp)

    def getPose3d(self):
        p = self._world.get_pose()
        return self._Obj(x=p.x, y=p.y, yaw=p.yaw)

    def getBumperData(self):
        b = self._world.get_bumper()
        return self._Obj(state=b.state, bumper=b.bumper)

    def setV(self, v):
        self._v = float(v)

    def setW(self, w):
        self._world.set_velocity(self._v, float(w))
        self._world.step()


class HALDriver:
    """Adapter from an injected JdeRobot ``HAL`` module to the Driver
    protocol."""

    def __init__(self, hal, *, num_beams: int = 180, tick_hz: Optional[float] = None):
        """``hal``: the injected module or object; ``tick_hz``: an optional
        rate limit for ``step()`` (None free-runs like the reference loop)."""
        self._hal = hal
        self._num_beams = num_beams
        self._tick_dt = None if not tick_hz else 1.0 / float(tick_hz)
        self._last_step = None

    def get_laser(self) -> LaserScan:
        data = self._hal.getLaserData()
        values = np.asarray(data.values, np.float32)
        if values.shape[0] != self._num_beams:
            # static shapes: pad with an out-of-range value, or truncate
            out = np.full(self._num_beams, float(data.maxRange) + 1.0, np.float32)
            n = min(values.shape[0], self._num_beams)
            out[:n] = values[:n]
            values = out
        return LaserScan(values=values, min_range=float(data.minRange),
                         max_range=float(data.maxRange), timestamp=float(data.timeStamp))

    def get_pose(self) -> Pose:
        p = self._hal.getPose3d()
        return Pose(float(p.x), float(p.y), float(p.yaw))

    def get_bumper(self) -> BumperState:
        b = self._hal.getBumperData()
        return BumperState(state=int(b.state), bumper=int(b.bumper))

    def set_velocity(self, v: float, w: float) -> None:
        self._hal.setV(float(v))
        self._hal.setW(float(w))

    def step(self) -> bool:
        """The live simulator advances itself; optionally pace the loop."""
        if self._tick_dt is not None:
            now = time.monotonic()
            if self._last_step is not None:
                remaining = self._tick_dt - (now - self._last_step)
                if remaining > 0:
                    time.sleep(remaining)
            self._last_step = time.monotonic()
        return True
