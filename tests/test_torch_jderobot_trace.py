"""JdeRobot HAL traces: the port's ``io/jderobot_trace.py`` against the JAX
package's.  Both record the same trace from the same world (byte for byte),
load the committed traces into equal logs, refuse the same garbage, and the
committed corridor trace replays through the port's online loop (the fused
tick on the CPU) within the JAX test's ATE bound."""

import json
import os

import numpy as np
import pytest
import torch

from fastslam_tpu.drivers.jderobot_hal import SimHAL as JaxSimHAL
from fastslam_tpu.drivers.sim_world import SimWorld as JaxSimWorld
from fastslam_tpu.io import jderobot_trace as jax_trace

from fastslam_tpu_torch.app.runner import run_driver
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.drivers.jderobot_hal import SimHAL
from fastslam_tpu_torch.drivers.replay import ReplayDriver
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.io.jderobot_trace import load_hal_trace, record_hal_trace

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "jderobot")
TRACES = sorted(f for f in os.listdir(DATA) if f.endswith(".jsonl"))


def assert_logs_equal(a, b):
    for name in ("scans", "timestamps", "cmd_v", "cmd_w", "bumper_state", "bumper_id",
                 "gt_poses"):
        got, want = getattr(a, name), getattr(b, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (a.min_range, a.max_range) == (b.min_range, b.max_range)


def test_record_matches_jax_byte_for_byte(tmp_path):
    got, want = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    assert record_hal_trace(got, SimHAL(SimWorld(seed=7)), 40) == 40
    assert jax_trace.record_hal_trace(want, JaxSimHAL(JaxSimWorld(seed=7)), 40) == 40
    assert open(got, "rb").read() == open(want, "rb").read()
    log = load_hal_trace(got)
    assert log.scans.shape == (40, 180) and np.all(np.diff(log.timestamps) > 0)
    assert log.min_range == pytest.approx(0.06)
    with open(got) as f:
        rec = json.loads(f.readline())
    assert set(rec) == {"laserData", "pose3d", "bumper", "cmd"}
    assert set(rec["laserData"]) == {"values", "minRange", "maxRange", "timeStamp"}


@pytest.mark.parametrize("name", TRACES)
def test_committed_traces_load_as_jax_loads_them(name):
    path = os.path.join(DATA, name)
    log = load_hal_trace(path)
    assert len(log) == 300 and log.scans.shape[1] == 180
    assert_logs_equal(log, jax_trace.load_hal_trace(path))


def test_loader_rejects_garbage_and_pads_ragged(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text("not json\n")
    for load in (load_hal_trace, jax_trace.load_hal_trace):
        with pytest.raises(ValueError, match="not a JSON record"):
            load(str(p))
    ragged = tmp_path / "ragged.jsonl"
    ragged.write_text("\n".join(json.dumps({"laserData": {
        "values": [1.0] * n, "minRange": 0.1, "maxRange": 10.0, "timeStamp": float(n)}})
        for n in (4, 5)) + "\n")
    for load in (load_hal_trace, jax_trace.load_hal_trace):
        with pytest.raises(ValueError, match="inconsistent beam counts"):
            load(str(ragged))
    log = load_hal_trace(str(ragged), num_beams=6)
    assert log.scans.shape == (2, 6) and (log.scans[:, 5] > 10.0).all()
    assert_logs_equal(log, jax_trace.load_hal_trace(str(ragged), num_beams=6))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    with pytest.raises(ValueError, match="empty trace"):
        load_hal_trace(str(empty))


def test_canned_trace_replays_with_ate_bound():
    log = load_hal_trace(os.path.join(DATA, "corridor_seed3_300.jsonl"))
    cfg = FastSLAMConfig(num_particles=128, max_landmarks=32, warmup_iterations=150,
                         parity_mode=False)
    hist = run_driver(ReplayDriver(log), cfg, rng=0, device="cpu")
    assert set(hist.stage_seconds) == {"tick"}     # the fused tick
    m = hist.metrics()
    assert np.isfinite(m["ate_rmse_m"]) and m["ate_rmse_m"] < 0.1, m
