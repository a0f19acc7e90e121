"""The reference facade: the port's ``Robot``, ``EvaluationUtils`` and
``Serializer`` against the JAX package's over the same worlds, and the
top-level exports of both packages."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fastslam_tpu
from fastslam_tpu.drivers.sim_world import SimWorld as JaxSimWorld
from fastslam_tpu.io.serializer import deserialize_tick as jax_deserialize_tick

import fastslam_tpu_torch
from fastslam_tpu_torch import (DirectedPoint, EvaluationUtils, Landmark, Particle, Robot,
                                Serializer)
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.io.serializer import deserialize_tick

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exports_match_jax_and_build_no_kernel():
    for name in ("run_driver", "HALDriver", "Robot", "EvaluationUtils", "Serializer"):
        assert name in fastslam_tpu_torch.__all__ and name in fastslam_tpu.__all__, name
        assert getattr(fastslam_tpu_torch, name).__module__.startswith("fastslam_tpu_torch")
    # a fresh interpreter: the import loads no kernel library and no JAX
    code = ("import sys, fastslam_tpu_torch\n"
            "from fastslam_tpu_torch.core import _build\n"
            "assert _build.load.cache_info().currsize == 0\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'fastslam_tpu.'))\n"
            "               for m in sys.modules), sorted(sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


def test_robot_facade_matches_jax():
    worlds = SimWorld(seed=5), JaxSimWorld(seed=5)
    robots = Robot(worlds[0], device="cpu"), fastslam_tpu.Robot(worlds[1])
    evals = EvaluationUtils(worlds[0]), fastslam_tpu.EvaluationUtils(worlds[1])
    for ev in evals:
        ev.try_to_initialize()
        assert ev.initialized
    moved = 0.0
    for t in range(12):
        pts = [r.scan_environment() for r in robots]
        np.testing.assert_array_equal(pts[0], pts[1])
        assert pts[0].ndim == 2 and pts[0].shape[1] == 2 and pts[0].shape[0] > 100
        cmds = [r.move(0.3, 0.5) for r in robots]
        assert cmds[0] == cmds[1]
        for w in worlds:
            w.step()
        odo = [r.get_transformation(*cmds[0]) for r in robots]
        assert odo[0] == odo[1]
        icp = [r.get_transformation_icp(p, cmds[0][0]) for r, p in zip(robots, pts)]
        np.testing.assert_allclose(icp[0], icp[1], rtol=0, atol=1e-4, err_msg=f"tick {t}")
        moved += abs(icp[0][0]) + abs(icp[0][1])
        for ev in evals:
            ev.set_actual_pos()
        res = [ev.evaluate_estimation(DirectedPoint(0.1, 0.0, 0.0)) for ev in evals]
        assert res[0][0].to_dict() == pytest.approx(res[1][0].to_dict())
        assert (res[0][1].x, res[0][1].y, res[0][1].yaw) == pytest.approx(
            (res[1][1].x, res[1][1].y, res[1][1].yaw))
    assert moved > 0.05     # the ICP odometry saw the motion


def test_serializer_facade_matches_jax(tmp_path, monkeypatch):
    for tag, ser, models in (("port", Serializer, (DirectedPoint, Particle, Landmark)),
                             ("jax", fastslam_tpu.Serializer,
                              (fastslam_tpu.DirectedPoint, fastslam_tpu.Particle,
                               fastslam_tpu.Landmark))):
        dp, part, lm = models
        monkeypatch.setattr(ser, "shared_path", str(tmp_path / tag))
        ser.serialize(dp(1, 2, 0.3), dp(1, 2, 0.31), [part(0, 0, 0, weight=1.0)],
                      [lm(3, 4)], {"distance": 0.01})
    got = deserialize_tick(str(tmp_path / "port" / "fast_slam.json"))
    want = jax_deserialize_tick(str(tmp_path / "jax" / "fast_slam.json"))
    assert got == want and got["landmarks"] == [(3.0, 4.0)]
