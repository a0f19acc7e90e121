"""The port's BASELINE config #5 run (``eval/backend_1m.py``) against
``scripts/bench_backend_1m.py:run`` on a 1-device CPU mesh, on a small
survey world (20,000 landmarks, 25 keyframes, 2 GN iterations), at 1 and 2
CPU shards: the counts exactly, the keyframe errors within 1e-4 m and the
total errors within 1e-3 relative (the backend's bars).  The raw keyframe
error after the optimization is left out: it measures the gauge (the
anchor's heading slack), which the port's float64 solve of the reduced
system and the reference's float32 one leave differently (0.06-0.9 m apart
on the small worlds tried, the gauge-aligned errors agreeing to ~1e-6 on
this one).  A dropped factor raises; the script's assertions pass and
fail as the script's do.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from fastslam_tpu_torch.eval import backend_1m

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import bench_backend_1m as script  # noqa: E402

torch.set_num_threads(1)

WORLD = dict(n_landmarks=20_000, k=25, iters=2, lm_capacity=1 << 15,
             factor_capacity=1 << 17)
COUNTS = ("n_landmarks_requested", "n_landmarks_built", "n_factors", "lm_capacity",
          "factor_capacity", "dropped_factors", "keyframes", "align_pairs_registered",
          "optimize_iters")
METRES = ("mean_keyframe_error_before_m", "mean_keyframe_error_before_gauge_aligned_m",
          "mean_keyframe_error_consensus_m", "mean_keyframe_error_after_gauge_aligned_m")


@pytest.fixture(scope="module")
def jax_run():
    return script.run(WORLD["n_landmarks"], k=WORLD["k"], iters=WORLD["iters"], n_devices=1,
                      lm_capacity=WORLD["lm_capacity"],
                      factor_capacity=WORLD["factor_capacity"])


@pytest.mark.parametrize("shards", [1, 2])
def test_run_matches_the_script(jax_run, shards):
    got = backend_1m.run(WORLD["n_landmarks"], k=WORLD["k"], iters=WORLD["iters"],
                         shards=shards, device="cpu", lm_capacity=WORLD["lm_capacity"],
                         factor_capacity=WORLD["factor_capacity"])
    # the script's keys, and peak device memory beside peak RSS
    assert set(jax_run) - {"platform"} <= set(got)
    assert {"peak_device_memory_gb", "device", "power_limit_w"} <= set(got)
    assert got["peak_device_memory_gb"] is None and got["device"] == "cpu"
    assert got["n_devices"] == shards
    for k in COUNTS:
        assert got[k] == jax_run[k], k
    for k in METRES:
        np.testing.assert_allclose(got[k], jax_run[k], rtol=0, atol=1e-4, err_msg=k)
    for k in ("total_error_before", "total_error_after"):
        np.testing.assert_allclose(got[k], jax_run[k], rtol=1e-3, err_msg=k)
    # the optimizer closed the loops: the script's bars hold
    assert backend_1m.check(got) == []
    assert got["total_error_after"] < 0.1 * got["total_error_before"]


def test_a_dropped_factor_raises():
    with pytest.raises(ValueError, match="factors dropped"):
        backend_1m.run(20_000, k=25, iters=1, shards=2, device="cpu", lm_capacity=1 << 15,
                       factor_capacity=1 << 14)


def test_checks_are_the_scripts():
    committed = json.load(open(backend_1m.COMMITTED))
    base = dict(committed, n_landmarks_requested=1_100_000)
    assert backend_1m.check(base, committed) == []
    b = committed["mean_keyframe_error_after_gauge_aligned_m"]
    broken = {
        "committed": dict(base, mean_keyframe_error_after_gauge_aligned_m=b + 0.06 + 0.25 * b),
        "dropped": dict(base, dropped_factors=1),
        "under 1M": dict(base, n_landmarks_built=990_000),
        "3 %": dict(base, n_landmarks_built=1_140_000),
        "0.6x": dict(base, mean_keyframe_error_after_gauge_aligned_m=0.7),
        "down": dict(base, total_error_after=base["total_error_before"] + 1.0),
    }
    for name, out in broken.items():
        assert len(backend_1m.check(out, committed)) >= 1, name
    # within 0.05 + 0.25 b of the committed error passes
    near = dict(base, mean_keyframe_error_after_gauge_aligned_m=b + 0.04 + 0.25 * b)
    assert backend_1m.check(near, committed) == []


def test_main_writes_the_artifact(tmp_path, capsys, monkeypatch):
    run = backend_1m.run
    monkeypatch.setattr(backend_1m, "run", lambda *a, **kw: run(
        *a, lm_capacity=WORLD["lm_capacity"], factor_capacity=WORLD["factor_capacity"], **kw))
    out = tmp_path / "backend.json"
    argv = ["--landmarks", "20000", "--keyframes", "25", "--iters", "2", "--shards", "2",
            "--device", "cpu", "--out", str(out)]
    assert backend_1m.main(argv + ["--committed", ""]) == 0
    saved = json.loads(out.read_text())
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line.pop("broken") == [] and line == saved
    # held to the committed 1.1M-landmark artifact, this world's error is far below
    assert backend_1m.main(argv) == 1
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert len(line["broken"]) == 1 and "committed" in line["broken"][0]
