"""The plain reference of the production hooks' files: what a checkpoint, a
viewer snapshot and the metrics log hold at a tick, worked out from the
state the harness copied there, and how far a file is from it.

* :func:`checkpoint_gap`: a checkpoint opened with ``zipfile`` and
  ``np.load`` (not the program's loader), every array against the state
  transposed to the blocks layout by :func:`blocks`, the iteration, the
  robot pose and the generator's state;
* :func:`snapshot_gaps`: the viewer's JSON against the global map of
  :func:`global_map`, a plain DBSCAN of the landmarks of 32 particles, and
  against the estimate, the ground truth and the particles the serializer
  keeps (500 by ``linspace``);
* :func:`metrics_gap`: the ticks of a stretch whose ``tick`` record is
  missing, out of order or carries another distance.

Plain numpy (and torch only to read the harness's copies); nothing of the
program.
"""

from __future__ import annotations

import json
import math
import zipfile

import numpy as np

# particles of the sampled maps and of a snapshot (the viewer's subsample)
MAP_PARTICLES = 32
VIEW_PARTICLES = 500


def host(state: dict) -> dict:
    """The harness's copies (tensors) as numpy arrays."""
    return {k: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)) for k, v in state.items()}


def read_npz(path: str) -> dict:
    """Every array of an ``.npz`` archive by name, read with ``zipfile``."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            with z.open(name) as f:
                out[name.removesuffix(".npy")] = np.lib.format.read_array(f, allow_pickle=False)
    return out


def blocks(planes: dict) -> dict:
    """``[L, P]`` planes -> ``lm_mean [P, L, 2]`` and ``lm_cov [P, L, 4]``
    (row-major 2 x 2; a missing ``lm_cc`` plane is ``lm_cb``, the production
    covariance being symmetric), beside poses, log-weights and counts."""
    cc = planes.get("lm_cc")
    cc = planes["lm_cb"] if cc is None else cc
    return {"poses": planes["poses"], "log_weights": planes["log_weights"],
            "lm_count": planes["lm_count"],
            "lm_mean": np.stack([planes["lm_mx"].T, planes["lm_my"].T], axis=-1),
            "lm_cov": np.stack([planes["lm_ca"].T, planes["lm_cb"].T, cc.T,
                                planes["lm_cd"].T], axis=-1)}


def _gap(a, b) -> float:
    """The widest difference of two arrays of one shape and dtype; inf
    otherwise, and for NaN."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return math.inf
    if a.size == 0:
        return 0.0
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return float(np.nan_to_num(np.max(d), nan=np.inf))


def checkpoint_gap(path: str, planes: dict, tick: int, robot, generator_state) -> float:
    """How far the checkpoint at ``path`` is from the state ``planes``
    (numpy, planes layout) of tick ``tick`` with its robot pose and
    generator state: the widest difference of an array, inf for a file that
    does not read, an array missing or of another shape or dtype, another
    iteration or another generator state; 0 where it reads back bit for
    bit."""
    try:
        z = read_npz(path)
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        return math.inf
    want = blocks(planes)
    if any(k not in z for k in (*want, "iteration", "robot_pose", "torch_generator_state")):
        return math.inf
    if "layout" in z or int(z["iteration"]) != tick:
        return math.inf
    if not np.array_equal(z["torch_generator_state"], np.asarray(generator_state)):
        return math.inf
    gap = _gap(z["robot_pose"], np.asarray(robot, np.float64))
    for k, v in want.items():
        gap = max(gap, _gap(z[k], v))
    return gap


def global_map(lm_mx, lm_my, lm_count, eps: float, frac: float) -> np.ndarray:
    """The viewer's global map: DBSCAN of the landmarks of every ``P // n``-th
    particle (``n = min(P, 32)``), ``[K, 2]`` centroids in float64, one per
    cluster, ordered by the cluster's least core index.

    ``min_samples`` is ``floor(0.7 x`` the mean landmarks per sampled
    particle ``)`` in float32, and none below 1.  A point is core where its
    eps-ball (itself included; squared distances in float32, as the map is
    stored) holds ``min_samples`` valid points; a cluster is a connected set
    of core points with each border point (not core, a core point within
    eps) joined to the cluster of its least-labelled core neighbour."""
    lm_count = np.asarray(lm_count)
    p, l = lm_count.shape[0], lm_mx.shape[0]
    n = min(p, MAP_PARTICLES)
    sel = np.arange(n) * max(p // n, 1)
    pts = np.stack([lm_mx[:, sel].T, lm_my[:, sel].T], axis=-1).reshape(-1, 2)
    valid = (np.arange(l)[None, :] < lm_count[sel][:, None]).reshape(-1)
    avg = np.float32(valid.sum()) / np.float32(n)
    min_samples = math.floor(avg * np.float32(frac))
    if min_samples < 1:
        return np.zeros((0, 2))
    d = pts[:, None, :] - pts[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    adj = (d2 <= np.float32(eps * eps)) & valid[:, None] & valid[None, :]
    core = valid & (adj.sum(axis=1) >= min_samples)
    label = np.full(len(pts), -1)
    for i in np.flatnonzero(core):          # in index order: i is its cluster's least
        if label[i] >= 0:
            continue
        label[i], stack = i, [i]
        while stack:
            j = stack.pop()
            for k in np.flatnonzero(adj[j] & core & (label < 0)):
                label[k] = i
                stack.append(k)
    for j in np.flatnonzero(valid & ~core):
        near = label[adj[j] & core]
        if near.size:
            label[j] = near.min()
    roots = np.unique(label[label >= 0])
    return np.array([pts[label == r].astype(np.float64).mean(axis=0) for r in roots]
                    ).reshape(-1, 2)


def view_particles(poses: np.ndarray) -> np.ndarray:
    """The particles a snapshot keeps: all, or 500 spread by ``linspace``."""
    if poses.shape[0] <= VIEW_PARTICLES:
        return poses
    return poses[np.linspace(0, poses.shape[0] - 1, VIEW_PARTICLES).astype(int)]


def snapshot_gaps(path: str, planes: dict, est, gt, eps: float, frac: float) -> tuple:
    """How far the viewer's snapshot at ``path`` is from the tick whose
    state (numpy planes: poses and the maps), estimate and ground truth are
    given: ``(map gap, pose gap)``, the widest difference of a landmark of
    the global map, and of the estimate, the ground truth or a particle;
    inf for a file that does not read or another number of landmarks or
    particles."""
    try:
        with open(path) as f:
            data = json.load(f)
        pose = lambda d: [d["x"], d["y"], d["yaw"]]
        got_est = np.array(pose(data["estimated_robot_pos"]))
        got_gt = np.array(pose(data["actual_robot_pos"]))
        got_parts = np.array([pose(q) for q in data["particles"]]).reshape(-1, 3)
        got_map = np.array([[q["x"], q["y"]] for q in data["landmarks"]]).reshape(-1, 2)
    except (OSError, ValueError, KeyError, TypeError):
        return math.inf, math.inf
    want_map = global_map(planes["lm_mx"], planes["lm_my"], planes["lm_count"], eps, frac)
    want_parts = view_particles(planes["poses"]).astype(np.float64)
    return (_gap(got_map, want_map),
            max(_gap(got_est, np.asarray(est, np.float64)),
                _gap(got_gt, np.asarray(gt, np.float64)), _gap(got_parts, want_parts)))


def distance(est, gt) -> float:
    """The distance a ``tick`` record carries: the estimate's from the
    ground truth in the plane."""
    return float(np.hypot(gt[0] - est[0], gt[1] - est[1]))


def metrics_gap(path: str, first: int, last: int, est: np.ndarray, gt: np.ndarray) -> float:
    """The ticks ``first..last`` whose ``tick`` record is missing, out of
    order (the records of the stretch must come in tick order, one each), or
    carries another distance than ``est[t]``'s from ``gt[t]``; a line that
    does not parse counts as no record."""
    seen = []
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return float(last - first + 1)
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if rec.get("kind") == "tick" and first <= rec.get("tick", -1) <= last:
            seen.append(rec)
    bad = 0
    for t in range(first, last + 1):
        k = t - first
        rec = seen[k] if k < len(seen) else None
        if rec is None or rec["tick"] != t or rec.get("distance") != distance(est[t], gt[t]):
            bad += 1
    return float(bad + max(len(seen) - (last - first + 1), 0))
