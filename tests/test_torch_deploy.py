"""The port's deployment pipeline on the CPU: ``deploy/launch_torch.sh`` (the
record -> ``run --production`` commands of ``deploy/launch.sh`` through
``python -m fastslam_tpu_torch``) and the reference control loop of
``examples/jde_robots_main_torch.py``, each in a subprocess, as
``tests/test_deploy.py`` runs the JAX package's."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(REPO, "deploy", "launch_torch.sh")


def test_launch_script_exists_and_is_executable():
    assert os.path.exists(LAUNCHER)
    assert os.access(LAUNCHER, os.X_OK)


def test_launch_pipeline_on_the_cpu(tmp_path):
    env = dict(os.environ, SKIP_INSTALL="1", DEVICE="cpu", TICKS="200", PARTICLES="256",
               OUT=str(tmp_path), OMP_NUM_THREADS="1")
    out = subprocess.run([LAUNCHER], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=420)
    assert out.returncode == 0, out.stderr[-2000:]
    record, run = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert record["ticks"] == 200 and os.path.exists(tmp_path / "log.npz")
    # 200 ticks is mostly warmup; the pipeline must produce finite,
    # sane-magnitude metrics end to end
    assert 0.0 <= run["ate_rmse_m"] < 1.0
    assert 0.0 <= run["mean_angular_error_rad"] < 0.5
    assert run["device"] == "cpu"


def test_reference_control_loop_example_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "jde_robots_main_torch.py"),
         "--ticks", "40", "--device", "cpu", "--shared", str(tmp_path)],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=420)
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("final: est=(") and "distance=" in last
    assert (tmp_path / "fast_slam.json").exists()
