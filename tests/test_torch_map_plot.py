"""Map plots: the port's ``viz/map_plot.py`` against the JAX package's on
the same snapshot and the same run (the same artists, the same data), the
CLI's ``run --plot`` and ``viz``, and the package importing without
matplotlib."""

import json
import os
import subprocess
import sys

import matplotlib
import numpy as np

matplotlib.use("Agg")

from fastslam_tpu.viz import map_plot as jax_map_plot

from fastslam_tpu_torch.app import cli
from fastslam_tpu_torch.app.runner import RunHistory
from fastslam_tpu_torch.drivers.replay import record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.viz import map_plot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def artists(ax):
    """What an axes draws: each line's and quiver's data, the limits, the
    legend labels."""
    lines = [(l.get_color(), np.asarray(l.get_xydata())) for l in ax.get_lines()]
    quivers = [(np.asarray(q.get_offsets()), np.asarray(q.U), np.asarray(q.V))
               for q in ax.collections]
    legend = ax.get_legend()
    labels = [t.get_text() for t in legend.get_texts()] if legend else []
    return lines, quivers, ax.get_xlim(), ax.get_ylim(), labels, ax.get_title()


def assert_same_artists(a, b):
    la, qa, *rest_a = artists(a)
    lb, qb, *rest_b = artists(b)
    assert rest_a == rest_b
    assert [c for c, _ in la] == [c for c, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        np.testing.assert_allclose(x, y)
    assert len(qa) == len(qb)
    for x, y in zip(qa, qb):
        for u, v in zip(x, y):
            np.testing.assert_allclose(u, v)


def test_plot_map_draws_what_jax_draws(tmp_path):
    args = ((0, 0, 0), (0.1, 0, 0), [(0, 0, 0.1), (0.1, 0.1, 0.2)], [(1, 1), (2, -3)],
            {"average_deviation": 1.0, "distance": 0.1})
    fig, ax = map_plot.plot_map(*args)
    jfig, jax_ax = jax_map_plot.plot_map(*args)
    assert_same_artists(ax, jax_ax)
    assert [t.get_text() for t in fig.texts] == [t.get_text() for t in jfig.texts]
    out = str(tmp_path / "map.png")
    fig.savefig(out)
    assert os.path.getsize(out) > 1000


def test_plot_trajectory_draws_what_jax_draws():
    hist = RunHistory()
    rng = np.random.default_rng(0)
    hist.gt_poses = list(np.cumsum(rng.normal(0, 0.1, (30, 3)), axis=0))
    hist.est_poses = [g + rng.normal(0, 0.02, 3) for g in hist.gt_poses]
    _, axes = map_plot.plot_trajectory(hist)
    _, jaxes = jax_map_plot.plot_trajectory(hist)
    for a, b in zip(axes, jaxes):
        assert_same_artists(a, b)
    assert axes[1].get_title().startswith("ATE RMSE = ")


def test_cli_run_plot_and_viz(tmp_path, capsys, monkeypatch):
    log_path = str(tmp_path / "log.npz")
    record_log(SimWorld(seed=3), num_ticks=12).save(log_path)
    png = str(tmp_path / "traj.png")
    capsys.readouterr()
    assert cli.main(["run", "--log", log_path, "--plot", png, "--particles", "16",
                     "--landmarks", "8", "--warmup", "4", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["plot"] == png and os.path.getsize(png) > 1000
    seen = []
    monkeypatch.setattr(map_plot, "watch", lambda path, interval: seen.append((path, interval)))
    assert cli.main(["viz", "--path", "snap.json", "--interval", "0.25"]) == 0
    assert seen == [("snap.json", 0.25)]


def test_package_imports_without_matplotlib():
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import fastslam_tpu_torch, fastslam_tpu_torch.viz.map_plot\n"
            "import fastslam_tpu_torch.app.cli\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
