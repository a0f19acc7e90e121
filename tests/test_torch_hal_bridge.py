"""The live-HAL bridge: the port's ``HALDriver`` and ``SimHAL`` against the
JAX package's.  Over the same fake HAL both drivers read the same scans,
poses and bumpers; the port's online loop runs through the bridge (the
fused tick on the CPU) within the JAX test's ATE bound; short lasers are
padded out of range; ``tick_hz`` paces ``step()``."""

import time

import numpy as np
import torch

from fastslam_tpu.drivers.jderobot_hal import HALDriver as JaxHALDriver
from fastslam_tpu.drivers.jderobot_hal import SimHAL as JaxSimHAL
from fastslam_tpu.drivers.sim_world import SimWorld as JaxSimWorld

from fastslam_tpu_torch.app.runner import run_driver
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.drivers.jderobot_hal import HALDriver, SimHAL
from fastslam_tpu_torch.drivers.sim_world import SimWorld

torch.set_num_threads(1)


def test_driver_reads_what_jax_reads():
    got = HALDriver(SimHAL(SimWorld(seed=3)))
    want = JaxHALDriver(JaxSimHAL(JaxSimWorld(seed=3)))
    for t in range(30):
        g, w = got.get_laser(), want.get_laser()
        np.testing.assert_array_equal(g.values, w.values, err_msg=f"tick {t}")
        assert (g.min_range, g.max_range, g.timestamp) == (w.min_range, w.max_range,
                                                           w.timestamp)
        gp, wp = got.get_pose(), want.get_pose()
        assert (gp.x, gp.y, gp.yaw) == (wp.x, wp.y, wp.yaw)
        gb, wb = got.get_bumper(), want.get_bumper()
        assert (gb.state, gb.bumper) == (wb.state, wb.bumper)
        cmd = (0.0, 0.5) if gb.state else (0.3, 0.0)
        got.set_velocity(*cmd)
        want.set_velocity(*cmd)
        assert got.step() and want.step()


def test_hal_driver_runs_the_engine():
    cfg = FastSLAMConfig(num_particles=128, max_landmarks=32, warmup_iterations=60,
                         parity_mode=False)
    hist = run_driver(HALDriver(SimHAL(SimWorld(seed=3))), cfg, max_ticks=120, rng=0,
                      device="cpu")
    assert len(hist.est_poses) == 120            # a live driver never exhausts
    m = hist.metrics()
    assert np.isfinite(m["ate_rmse_m"]) and m["ate_rmse_m"] < 0.15, m


def test_hal_driver_laser_shape_coercion():
    class ShortLaserHAL(SimHAL):
        def getLaserData(self):
            d = super().getLaserData()
            d.values = d.values[:90]
            return d

    scan = HALDriver(ShortLaserHAL(SimWorld(seed=1)), num_beams=180).get_laser()
    assert scan.values.shape == (180,)
    _, valid = scan.to_points()
    assert not valid[90:].any()


def test_hal_driver_tick_pacing():
    drv = HALDriver(SimHAL(SimWorld(seed=1)), tick_hz=200.0)
    t0 = time.monotonic()
    for _ in range(5):
        assert drv.step()
    assert time.monotonic() - t0 >= 4 * 0.005 - 1e-3
