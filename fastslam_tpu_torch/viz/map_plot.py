"""Map visualization: the reference's ``landmark_map`` viewer, rebuilt
(counterpart of ``fastslam_tpu/viz/map_plot.py``).

The same visual language as the reference's viewer (estimated pose red
arrow, actual pose black, particles blue, landmarks green dots, a fixed
±10 m viewport, a results text block), drawn from a JSON snapshot
(:func:`plot_map`, :func:`watch`) or a whole
:class:`~fastslam_tpu_torch.app.runner.RunHistory` (:func:`plot_trajectory`).
matplotlib is imported only when a plot is drawn, so the package imports
where matplotlib is not installed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _quiver(ax, poses, color, label, zorder, scale=5):
    poses = np.asarray(poses, float).reshape(-1, 3)
    if poses.size == 0:
        return
    ax.quiver(poses[:, 0], poses[:, 1], np.cos(poses[:, 2]), np.sin(poses[:, 2]),
              color=color, label=label, zorder=zorder, scale=scale,
              scale_units="inches", width=0.004)


def plot_map(estimated_robot_pos, actual_robot_pos, particles: Sequence,
             landmarks: Sequence, results: Optional[dict] = None, ax=None,
             viewport: float = 10.0):
    """Draw one tick's snapshot; returns ``(figure, axes)``."""
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots(figsize=(7, 8))
    else:
        fig = ax.figure
    _quiver(ax, particles, "blue", "Particles", 2)
    _quiver(ax, [actual_robot_pos], "black", "Actual robot position", 3)
    _quiver(ax, [estimated_robot_pos], "red", "Estimated robot position", 4)
    lms = np.asarray(landmarks, float).reshape(-1, 2)
    if lms.size:
        ax.plot(lms[:, 0], lms[:, 1], "go", label="Landmarks", zorder=1)
    ax.set_xlim(-viewport, viewport)
    ax.set_ylim(-viewport, viewport)
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    ax.legend(loc="upper center", bbox_to_anchor=(0.5, -0.05), ncol=2)
    if results:
        lines = [
            f"Average deviation: {results.get('average_deviation', '—')}%",
            f"X deviation: {results.get('x_deviation', '—')}%",
            f"Y deviation: {results.get('y_deviation', '—')}%",
            f"Angular deviation: {results.get('angular_deviation', '—')}%",
            f"Distance: {results.get('distance', '—')} m",
        ]
        fig.text(0.02, 0.02, "\n".join(lines), fontsize=8, family="monospace")
    return fig, ax


def plot_trajectory(history, ax=None, title: str = "Trajectory"):
    """A whole run: ground-truth and estimated paths, and the position error
    per tick; returns ``(figure, axes)``."""
    import matplotlib.pyplot as plt

    est = np.asarray(history.est_poses)
    gt = np.asarray(history.gt_poses)
    if ax is None:
        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    else:
        fig, axes = ax.figure, ax
    axes[0].plot(gt[:, 0], gt[:, 1], "k-", label="ground truth")
    axes[0].plot(est[:, 0], est[:, 1], "r--", label="estimate")
    axes[0].set_aspect("equal")
    axes[0].legend()
    axes[0].set_title(title)
    err = np.linalg.norm(gt[:, :2] - est[:, :2], axis=1)
    axes[1].plot(err)
    axes[1].set_xlabel("tick")
    axes[1].set_ylabel("position error [m]")
    axes[1].set_title(f"ATE RMSE = {np.sqrt(np.mean(err ** 2)):.3f} m")
    return fig, axes


def watch(path: str = "workspace/shared/fast_slam.json", interval: float = 0.5):
    """Poll a shared JSON snapshot and redraw it (the viewer's main loop)."""
    import matplotlib.pyplot as plt

    from fastslam_tpu_torch.io.serializer import deserialize_tick

    plt.ion()
    fig, ax = plt.subplots(figsize=(7, 8))
    while True:
        snap = deserialize_tick(path)
        if snap is not None:
            ax.clear()
            plot_map(snap["estimated_robot_pos"], snap["actual_robot_pos"],
                     snap["particles"], snap["landmarks"], snap["results"], ax=ax)
            fig.canvas.draw_idle()
        plt.pause(interval)
