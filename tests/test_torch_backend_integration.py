"""The port's trajectory smoother (``backend/integration.py``) against
``fastslam_tpu.backend.integration`` on a 120-tick seed-3 drive with a
drifted trajectory estimate.

* The frontend stage, as ``test_torch_frontend.py`` holds it: the keyframe
  measurements have the same counts and agree within 1e-4; with tracking,
  the same track ids exactly.
* The graph and optimize stages on the same measurements (JAX's): the graph
  equal exactly, the smoothed keyframes within 1e-4 and the final error
  within 1e-3 relative.
* ``smooth_trajectory`` end to end, greedy and tracked: the same keyframes,
  landmark and factor counts, the final error within 1e-3 relative and the
  poses within 1e-3.  The re-association rounds are not compared: a round
  that rebuilds the same graph is kept when its per-factor error is lower,
  and on this drive the two errors agree to ~1e-6 relative, so the port's
  float64 sums and JAX's float32 ones may decide it either way.
"""

import numpy as np
import pytest
import torch

from fastslam_tpu.backend import builder as jax_builder
from fastslam_tpu.backend import integration as jax_integration
from fastslam_tpu.backend import pose_graph as jax_pg
from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.drivers.replay import record_log as jax_record_log
from fastslam_tpu.drivers.sim_world import SimWorld as JaxSimWorld

from fastslam_tpu_torch.backend import builder, integration, pose_graph
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.drivers.replay import record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld

torch.set_num_threads(1)

TICKS = 120
STRIDE = 10


@pytest.fixture(scope="module")
def drive():
    log = record_log(SimWorld(seed=3), num_ticks=TICKS)
    jlog = jax_record_log(JaxSimWorld(seed=3), num_ticks=TICKS)
    np.testing.assert_array_equal(log.scans, jlog.scans)
    rng = np.random.default_rng(0)
    est = log.gt_poses + np.cumsum(rng.normal(0, 0.01, (TICKS, 3)), axis=0)
    return log, jlog, est


@pytest.mark.parametrize("tracking", [False, True])
def test_keyframe_measurements_equal_jax(drive, tracking):
    log, jlog, _ = drive
    ticks = np.arange(0, TICKS, STRIDE)
    if tracking:
        got, got_ids = integration.extract_tracked_keyframe_measurements(
            log, ticks, FastSLAMConfig(), device="cpu")
        want, want_ids = jax_integration.extract_tracked_keyframe_measurements(
            jlog, ticks, JaxConfig())
        for g, w in zip(got_ids, want_ids):
            np.testing.assert_array_equal(g, w)
    else:
        got = integration.extract_keyframe_measurements(log, ticks, FastSLAMConfig(),
                                                        device="cpu")
        want = jax_integration.extract_keyframe_measurements(jlog, ticks, JaxConfig())
    assert [len(g) for g in got] == [len(w) for w in want]
    assert sum(len(g) for g in got) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_graph_and_optimize_stages_equal_jax(drive):
    _, jlog, est = drive
    ticks = np.arange(0, TICKS, STRIDE)
    ms = jax_integration.extract_keyframe_measurements(jlog, ticks, JaxConfig())
    kw = dict(association_gate=0.8, max_landmarks=64, max_factors=1024)
    gj = jax_builder.build_pose_graph(est[ticks], ms, **kw)
    gt_ = builder.build_pose_graph(est[ticks], ms, device="cpu", **kw)
    for name, g, w in zip(gj._fields, gt_, gj):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    pj, _, ej, _ = jax_pg.optimize(gj, num_iters=15)
    pt, _, et, _ = pose_graph.optimize(gt_, num_iters=15)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4, atol=1e-4)
    assert abs(float(et) - float(ej)) <= 1e-3 * abs(float(ej))


@pytest.mark.parametrize("tracking", [False, True])
def test_smooth_trajectory_equals_jax(drive, tracking):
    log, jlog, est = drive
    pj, tj, ij = jax_integration.smooth_trajectory(jlog, est, JaxConfig(),
                                                   use_tracking=tracking)
    pt, tt, it = integration.smooth_trajectory(log, est, FastSLAMConfig(),
                                               use_tracking=tracking, device="cpu")
    np.testing.assert_array_equal(tt, tj)
    for key in ("num_keyframes", "num_landmarks", "num_factors"):
        assert it[key] == ij[key], key
    assert abs(it["final_error"] - ij["final_error"]) <= 1e-3 * abs(ij["final_error"])
    np.testing.assert_allclose(pt, pj, rtol=1e-3, atol=1e-3)
    before = np.linalg.norm(est[tt, :2] - log.gt_poses[tt, :2], axis=1).mean()
    assert np.isfinite(pt).all() and pt.shape == (len(tt), 3) and before > 0
