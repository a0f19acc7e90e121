"""The hooked online cell on the CPU at a tiny size: a run is ``correct``
with every check of the hooks' files, each fault planted in the hooks
reads ``correct`` false, a traced run reports the five hook readers, and
the readers are silent where they find nothing."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import control_hooks, harness
from benchmark.drivers import online_hooks
from fastslam_tpu_torch.utils import profiling
from harness_fixtures import TINY

CELL = "online-hooks-fs2-icp-100k"
READERS = ["hook_checkpoint_ms", "hook_serialize_ms", "hook_health_ms", "hook_share_pct",
           "checkpoint_mb"]
HOOK_CHECKS = {"checkpoints_checked_short", "checkpoint_gap", "snapshots_checked_short",
               "snapshot_gap", "snapshot_pose_gap", "metrics_gap", "health_checks_missed", "snapshot_lag_ticks",
               "checkpoint_lag_ticks"}


# the fault planted and the check that has to catch it
LAG_FAULTS = {"snapshot_sparse": "snapshot_lag_ticks",
              "checkpoint_skipped": "checkpoint_lag_ticks"}


@pytest.fixture
def cell():
    """The cell with its checked ticks, checkpoints and snapshots inside a
    short CPU window: it closes at the first checkpoint, tick 30, and the
    checkpoint's age is held to that period as the cell's is to 200."""
    c = harness.load_cell(CELL)
    c.traffic["check_buckets"] = [0, 2, 5]
    c.config["hooks"].update(checkpoint_every=30)
    c.limits["checkpoint_lag_ticks"] = 30.0
    return c


def line_of(cell, trace, **kw):
    out = online_hooks.run(cell, 2**31 + 17, 0.05, trace, "cpu", overrides=TINY, **kw)
    return harness.result_line(cell, torch.device("cpu"), out, trace)


def test_hooked_run_correct_on_cpu(cell):
    line = line_of(cell, False)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert HOOK_CHECKS | {"out_gap", "particles_apart"} <= set(line["checks"])
    # the oldest each file was after a tick: the tick before a write
    assert line["checks"]["checkpoint_lag_ticks"]["value"] == 29.0
    assert line["checks"]["snapshot_lag_ticks"]["value"] == 9.0


def test_window_closes_at_a_checkpoint_and_removes_its_files(cell):
    run = online_hooks.HooksRun(cell, 2**31 + 3, "cpu", overrides=TINY)
    try:
        run.setup(0.05)
        run.window(0.05, False)
        assert run.t == 31 and run.hooks.last_checkpoint_tick == run.written["checkpoint"] == 30
        assert run.written["snapshot"] == 30
        assert run.kept["checkpoint"]["first"]["tick"] is not None
    finally:
        run.close()
    assert not __import__("os").path.exists(run.dir)


@pytest.mark.parametrize("fault", sorted(control_hooks.FAULTS))
def test_planted_fault_is_not_correct(cell, fault):
    with control_hooks.planted(fault):
        line = line_of(cell, False)
    assert not line["correct"], line["checks"]
    if fault in LAG_FAULTS:
        failing = {k for k, c in line["checks"].items() if not c["value"] <= c["limit"]}
        assert LAG_FAULTS[fault] in failing, line["checks"]


def test_planted_restores_the_program():
    from fastslam_tpu_torch.app import runner
    from fastslam_tpu_torch.utils.logging_utils import MetricsLog

    program = lambda: (runner.save_checkpoint, runner.serialize_tick, MetricsLog.close,
                       runner.ProductionHooks.__init__)
    before = program()
    for fault in control_hooks.FAULTS:
        with control_hooks.planted(fault):
            assert program() != before
    assert program() == before


def test_control_readings_of_a_sound_run(cell):
    r = control_hooks.read_seed(cell, 7, 0.05, "cpu", overrides=TINY)
    assert r["checkpoint_gap"] == r["snapshot_pose_gap"] == r["metrics_gap"] == 0.0
    assert 0.0 <= r["snapshot_gap"] <= 1e-5 and r["ticks"] == 28


def test_traced_run_reports_the_hook_readers(cell):
    line = line_of(cell, True)
    assert line["correct"], line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(m) == set(READERS)
    assert all(m[k] > 0 for k in READERS)
    assert m["hook_share_pct"] < 100
    profiling.HOOK_TRACE.clear()
    profiling.TICK_TRACE.clear()


class Recorder:
    def __init__(self, rows):
        self._rows = rows

    def rows(self):
        return list(self._rows)


def synthetic_rows():
    """Four ticks of 10 ms hooks: health 1 ms each, a snapshot of 4 ms on
    ticks 0 and 2, a checkpoint of 8 ms and 2e6 bytes on tick 3."""
    ms = lambda x: int(x * 1e6)
    rows = []
    for i in range(4):
        spans = [("health", "hook", 0, ms(1))]
        counters = {"health_failed": 0, "recoveries": 0}
        if i % 2 == 0:
            spans.append(("serialize", "hook", ms(1), ms(5)))
        if i == 3:
            spans.append(("checkpoint", "hook", ms(1), ms(9)))
            counters["checkpoint_bytes"] = 2e6
        rows.append({"key": i, "spans": spans + [("hook", None, 0, ms(10))], "stages": {},
                     "counters": counters})
    return rows


def test_readers_on_synthetic_rows(monkeypatch):
    monkeypatch.setattr(profiling, "HOOK_TRACE", Recorder(synthetic_rows()))
    ctx = {"kind": "online", "ticks": 4, "window_s": 0.08}
    want = {"hook_checkpoint_ms": 8.0, "hook_serialize_ms": 4.0, "hook_health_ms": 1.0,
            "hook_share_pct": 50.0, "checkpoint_mb": 2.0}
    for name in READERS:
        read = harness.metric_reader(name)
        assert read(ctx) == pytest.approx(want[name]), name
        assert read({}) is None
        assert read({**ctx, "ticks": 5}) is None                 # another count
        assert read({**ctx, "kind": "filter"}) is None
    monkeypatch.setattr(profiling, "HOOK_TRACE", Recorder([]))
    assert all(harness.metric_reader(n)(ctx) is None for n in READERS)


def test_readers_silent_without_the_recorder(monkeypatch):
    """A program that keeps no hook rows (no ``HOOK_TRACE``) gives nothing."""
    monkeypatch.delattr(profiling, "HOOK_TRACE")
    ctx = {"kind": "online", "ticks": 4, "window_s": 0.08}
    assert all(harness.metric_reader(n)(ctx) is None for n in READERS)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, benchmark.reference.hooks\n"
            "print(','.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True)
    tops = set(out.stdout.strip().split(","))
    assert not tops & ({"fastslam_tpu_torch", "torch"} | set(harness.FORBIDDEN_MODULES))


def test_config_is_fs2_icp_100k_with_hooks():
    base = harness.load_cell("online-fs2-icp-100k")
    c = harness.load_cell(CELL)
    assert c.config["program"] == base.config["program"]
    assert c.config["hooks"] == {"health": True, "metrics": True, "serialize_every": 10,
                                 "checkpoint_every": 200}
    drive_keys = set(base.traffic) - {"driver", "why", "trace_seconds"}
    assert {k: c.traffic[k] for k in drive_keys} == {k: base.traffic[k] for k in drive_keys}
    assert c.traffic["trace_seconds"] == 6
    for k in ("out_gap", "estimator_gap", "particles_apart", "apart_tolerance"):
        assert c.limits[k] == base.limits[k]
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    fps = next(m for m in bench["end_to_end"] if m["name"] == "frames_per_s")
    assert CELL in fps["workloads"]
