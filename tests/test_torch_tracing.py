"""Tracing inside the fused online tick, on the CPU: the recorder's bound,
the tick's rows (host spans, device stage marks on the host clock, the
counters read back with ``out``) while a profiler session is active and
none outside one, and the same ticks bit for bit with tracing on and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fastslam_tpu_torch.app.runner import SLAMRunner
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.drivers.replay import ReplayDriver, record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.utils import profiling

torch.set_num_threads(1)

MODES = {
    "motion": dict(),
    "fs2_icp_adaptive": dict(proposal_mode="fastslam2", use_icp_proposal=True, icp_blend=0.0,
                             adaptive_proposal_floors=True),
    "tracking": dict(track_corners=True),
    "resample_often": dict(resample_threshold_frac=0.99),
}
TICKS, TRACED_FROM = 10, 4


@pytest.fixture(scope="module")
def drive():
    return record_log(SimWorld(seed=3), num_ticks=TICKS)


@pytest.fixture
def tick_trace():
    profiling.TICK_TRACE.clear()
    yield profiling.TICK_TRACE
    profiling.TICK_TRACE.clear()


def drive_fused(log, cfg, traced):
    """``tick_fused`` over the drive, the ticks from ``TRACED_FROM`` on each
    inside a profiler session when ``traced``; returns the runner, the
    ``out`` rows, the poses, whether each tick left every particle the same
    weight, and the profiler's region names."""
    runner = SLAMRunner(cfg, rng=5, device="cpu")
    drv, prev_cmd, outs, poses, names = ReplayDriver(log), (0.0, 0.0), [], [], set()
    uniform = []
    for t in range(TICKS):
        scan = drv.get_laser()
        pts, valid = scan.to_points()
        v, w = prev_cmd
        prev_cmd = drv.commanded_velocity()
        rot, tr = runner.odometry(v, w, scan.timestamp)
        if traced and t >= TRACED_FROM:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                poses.append(runner.tick_fused(pts, valid, rot, tr, v))
            names |= {e.key for e in prof.key_averages()}
        else:
            poses.append(runner.tick_fused(pts, valid, rot, tr, v))
        outs.append(runner._last_out.copy())
        log_w = runner.state.log_weights
        uniform.append(bool(torch.all(log_w == log_w[0])))
        drv.step()
    return runner, np.asarray(outs), np.asarray(poses), uniform, names


@pytest.mark.parametrize("mode", sorted(MODES))
def test_traced_fused_ticks_keep_rows_and_the_same_bits(drive, tick_trace, mode):
    cfg = FastSLAMConfig(num_particles=64, max_landmarks=8, parity_mode=False,
                         warmup_iterations=3, **MODES[mode])
    plain, outs, poses, _, _ = drive_fused(drive, cfg, traced=False)
    assert tick_trace.rows() == []
    traced, t_outs, t_poses, uniform, names = drive_fused(drive, cfg, traced=True)
    assert outs.shape == (TICKS, 14)
    np.testing.assert_array_equal(t_outs, outs)
    np.testing.assert_array_equal(t_poses, poses)
    for name, want in plain.state.__dict__.items():
        if want is not None:
            assert torch.equal(getattr(traced.state, name), want), name

    icp = cfg.use_icp_proposal
    rows = tick_trace.rows()
    assert [r["key"] for r in rows] == list(range(TRACED_FROM, TICKS))
    stages = (["icp"] if icp else []) + ["frontend", "update", "resample"]
    spans = (["estimator"] if cfg.adaptive_proposal_floors else []) + ["submit", "wait"]
    # a due resample leaves every particle the same weight
    assert mode != "resample_often" or any(r["counters"]["resample_due"] for r in rows)
    for r in rows:
        assert list(r["stages"]) == stages and min(r["stages"].values()) >= 0.0
        assert set(r["counters"]) == ({"icp_iters", "resample_due"} if icp else {"resample_due"})
        assert r["counters"]["resample_due"] in (0.0, 1.0)
        assert not r["counters"]["resample_due"] or uniform[r["key"]]
        assert not icp or 1 <= r["counters"]["icp_iters"] <= cfg.icp_max_iterations
        by_name = {}
        for name, parent, t0, t1 in r["spans"]:
            assert parent == (None if name == "tick" else "tick") and t0 <= t1
            by_name[name] = by_name.get(name, 0) + t1 - t0
        assert sorted(by_name) == sorted(spans + ["tick"])
        assert sum(by_name[s] for s in spans) <= by_name["tick"]
    assert {f"fastslam.tick.{s}" for s in spans} | {"fastslam.tick"} <= names


def test_row_buffer_keeps_the_newest_and_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, "ROW_CAPACITY", 4)
    timer = profiling.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]):
        for key in range(6):
            with timer.row(key), timer.span("submit"):
                pass
        with pytest.raises(RuntimeError):
            with timer.row(6):
                raise RuntimeError("a tick that fails")
    assert [r["key"] for r in timer.rows()] == [2, 3, 4, 5] and timer.dropped == 2
    assert not timer.recording
    timer.clear()
    assert timer.rows() == [] and timer.dropped == 0


def test_capture_safe_marks_on_the_host_clock():
    marks = profiling.EventMarks("cpu", stages=("frontend", "update"))
    for _ in range(2):
        marks.start()
        marks("frontend")
        marks.count("due", torch.tensor(True))
        marks("update")
    ms = marks.stage_ms()
    assert list(ms) == ["frontend", "update"] and min(ms.values()) >= 0.0
    assert list(marks.counters) == ["due"] and bool(marks.counters["due"])
