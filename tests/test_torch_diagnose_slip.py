"""The port's slip forensics (``eval/diagnose_slip.py``) against
``scripts/diagnose_slip.py``.

The online form at seed 3 under slip, 100 ticks (the first turn starts at
tick 87): every key that no particle draw reaches is held tick by tick: the
odometry, the true motion and its error, the measurement counts exactly;
the ICP residuals, floors and bias at atol 1e-5 and the dial within its
ramp's slope times the tick's floor difference, as
``tests/test_torch_online.py`` holds ``icp_refine``; the blends, ratios of
the moments the floors come from, at the floors' relative error (rtol
1e-4: a floor 3.9e-7 off of 5.4e-3 moved the rotation blend 1.8e-5 of
0.61 in the 100 ticks); the estimate error as
well, since the first 150 ticks dead-reckon the ICP-refined odometry.  On a
noise-free motion drive past the warmup, the estimate error at 1e-4.  The
trace form on an 80-tick prefix of the corridor trace writes parseable JSON
with both odometry sequences, which part only where their command pairing
does.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from fastslam_tpu_torch.eval import diagnose_slip
from fastslam_tpu_torch.eval.oracle_ate import oracle_odometry
from fastslam_tpu_torch.app.runner import slipped_odometry
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.io.jderobot_trace import load_hal_trace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import diagnose_slip as script  # noqa: E402

torch.set_num_threads(1)

CORRIDOR = os.path.join(os.path.dirname(__file__), "..", "data", "jderobot",
                        "corridor_seed3_300.jsonl")
EXACT = ("tick", "type", "cmd_rot", "cmd_trans", "true_rot", "true_trans",
         "cmd_err_rot", "cmd_err_trans", "n_meas")
CLOSE = ("icp_ang", "icp_tx", "icp_ty", "sr_th", "sr_al", "lat", "floor_xy",
         "floor_th", "bias_th", "est_err")


def test_online_form_matches_the_script_on_every_draw_free_key():
    want = script.run_instrumented(3, particles=16, ticks=100)
    got = diagnose_slip.run_instrumented(3, particles=16, ticks=100, device="cpu")
    assert set(got) == set(want)
    for k in EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    for k in ("blend_xy", "blend_th"):     # ratios of the floors' moments
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=k)
    cfg = FastSLAMConfig()
    slope = 1.0 / (cfg.fs2_dial_hi_floor - cfg.fs2_dial_lo_floor)
    floor_diff = np.maximum(np.abs(np.subtract(got["floor_xy"], want["floor_xy"])),
                            np.abs(np.subtract(got["floor_th"], want["floor_th"])))
    assert np.all(np.abs(np.subtract(got["dial"], want["dial"]))
                  <= slope * floor_diff + 1e-7)
    np.testing.assert_allclose(got["ate"], want["ate"], rtol=0, atol=1e-5)
    assert sum(t == 0 for t in got["type"]) > 5          # the turn is in
    assert np.any(np.asarray(got["cmd_err_rot"]) != 0.0)


def test_noise_free_estimate_error_matches_the_script_past_the_warmup():
    # no motion noise and the proposal floors pinned at 0: every particle
    # samples the same pose whatever its draws
    overrides = dict(rotation_noise=0.0, translation_noise=0.0, proposal_floor_min=0.0,
                     proposal_floor_max=0.0)
    want = script.run_instrumented(3, particles=16, ticks=165, odometry_noise=(0.0, 0.0),
                                   overrides=overrides)
    got = diagnose_slip.run_instrumented(3, particles=16, ticks=165,
                                         odometry_noise=(0.0, 0.0), overrides=overrides,
                                         device="cpu")
    np.testing.assert_allclose(got["est_err"], want["est_err"], rtol=1e-4, atol=1e-4)
    assert got["est_err"][160] != got["est_err"][140]


def test_trace_form_writes_both_odometry_sequences(tmp_path):
    lines = open(CORRIDOR).read().splitlines(keepends=True)[:80]
    trace = tmp_path / "corridor_80.jsonl"
    trace.write_text("".join(lines))
    out = tmp_path / "out"
    assert diagnose_slip.main(["--trace", str(trace), "--particles", "64", "--device",
                               "cpu", "--results-dir", str(out)]) == 0
    rec = json.loads((out / "slip_diag_corridor_80_rng0.json").read_text())
    for side in ("engine", "oracle"):
        for k in ("rot", "trans", "slip_rot", "slip_trans", "err_rot", "err_trans", "err",
                  "dr_err"):
            assert len(rec[f"{side}_{k}"]) == 80 and np.all(np.isfinite(rec[f"{side}_{k}"]))
        assert np.isfinite(rec[f"{side}_ate"])
    assert [w["ticks"] for w in rec["windows"]] == ["0-24", "25-49", "50-74", "75-79"]
    # the same draw on every tick; the sides part only on the ticks whose
    # command pairing differs (the turn's first and last), by the pairing rule
    parts = diagnose_slip.parting_ticks(rec)
    assert parts["draws"] == [] and parts["differ"] == parts["pairing"]
    assert parts["pairing"] and all(67 <= t < 80 for t in parts["pairing"])
    # each side's odometry is the function its run calls
    log = load_hal_trace(str(trace))
    cfg = FastSLAMConfig(max_landmarks=64, warmup_iterations=150)
    np.testing.assert_array_equal(rec["engine_rot"],
                                  slipped_odometry(log, cfg, diagnose_slip.SLIP)[0])
    np.testing.assert_array_equal(rec["oracle_trans"],
                                  oracle_odometry(log, cfg, diagnose_slip.SLIP)[1])


def test_true_motion_and_dead_reckoning_invert_each_other():
    rng = np.random.default_rng(0)
    rots = np.where(rng.random(50) < 0.3, rng.normal(0, 0.1, 50), 0.0)
    trans = np.where(rots == 0.0, rng.uniform(0.0, 0.05, 50), 0.0)
    rots[0] = trans[0] = 0.0
    poses = diagnose_slip.dead_reckoning(rots, trans)
    got_r, got_t = diagnose_slip.true_motion(poses)
    np.testing.assert_allclose(got_r, rots, atol=1e-12)
    np.testing.assert_allclose(got_t, trans, atol=1e-12)


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diagnose_slip.main(["--seed", "3", "--ticks", "2"])
