"""Pose-graph construction from a SLAM run.

A numpy copy of ``fastslam_tpu/backend/builder.py``: the same association
engines and the same graphs, equal to the reference's exactly.  The
difference: a :class:`~fastslam_tpu_torch.backend.pose_graph.PoseGraph`
holds tensors, which :func:`build_pose_graph` puts on its ``device``
argument (the card unless the caller passes another); the functions that
take a graph return one on that graph's device.

Keyframes are subsampled ticks, odometry factors come from the relative
motion between consecutive keyframe pose estimates, and observation factors
are the tick's (range, bearing) corner measurements.  Landmark identities
are established by world-frame clustering of the projected observations.
Two association engines:

* ``greedy`` — exact sequential nearest-within-gate clustering with running
  means (order-dependent, O(F·L) Python); the accuracy reference for small
  windows.
* ``grid`` — vectorized grid-hash clustering (O(F log F) NumPy): snap each
  world-projected observation to a gate-sized cell, form per-cell centroids,
  then merge cells whose centroids sit within the gate of a 3x3-neighbor
  centroid.  This is what makes BASELINE config #5 (100k–1M landmarks)
  buildable in seconds.

``association="auto"`` (the default) picks greedy below
``_GRID_THRESHOLD`` observations and grid above it.

Host-side NumPy: graph construction is a one-off per optimization window,
not a hot path.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from fastslam_tpu_torch.backend.pose_graph import PoseGraph

# above this many observations, association="auto" switches from the exact
# sequential greedy pass to the vectorized grid hash
_GRID_THRESHOLD = 20_000


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def _world_project(kf: np.ndarray, obs_kf: np.ndarray,
                   obs_rb: np.ndarray) -> np.ndarray:
    """World-frame (x, y) of each observation from its keyframe pose, [F, 2]."""
    th = kf[obs_kf, 2] + obs_rb[:, 1]
    return np.stack([kf[obs_kf, 0] + obs_rb[:, 0] * np.cos(th),
                     kf[obs_kf, 1] + obs_rb[:, 0] * np.sin(th)], axis=-1)


def _grid_associate(
    kf: np.ndarray,
    obs_kf: np.ndarray,
    obs_rb: np.ndarray,
    association_gate: float,
    max_landmarks: int,
):
    """Vectorized grid-hash association; same contract as _greedy_associate.

    Cells are ``gate``-sized; pass 1 forms per-cell centroids, pass 2 merges
    cells whose centroids sit within the gate of a 3x3-neighbor centroid via
    min-label propagation (the same trick as frontend/clustering.py), so two
    observations of one corner falling either side of a cell boundary share
    a landmark.  Like the greedy pass's running means, chained merges can
    span more than one gate.  Landmark order is first-observation order,
    matching the greedy pass's first-seen numbering.  Returns
    (landmarks [J, 2] array, obs_lm [F] int, keep [F]).
    """
    f = len(obs_kf)
    if f == 0:
        return np.zeros((0, 2)), np.zeros(0, np.int32), np.zeros(0, bool)
    w = _world_project(kf, obs_kf, obs_rb)
    cell = np.floor(w / association_gate).astype(np.int64)
    # exact composite key (no hash collisions for |cell| < 2^31)
    key = (cell[:, 0] << 32) ^ (cell[:, 1] & 0xFFFFFFFF)

    # pass 1: per-cell centroids
    uniq, inv = np.unique(key, return_inverse=True)
    n_cells = len(uniq)
    sums = np.zeros((n_cells, 2))
    np.add.at(sums, inv, w)
    counts = np.bincount(inv, minlength=n_cells).astype(np.float64)
    cent = sums / counts[:, None]

    # pass 2: adjacency = 3x3-neighbor cells whose centroids are within the
    # gate; merge connected components by min-label propagation
    cell_xy = np.stack([uniq >> 32, uniq << 32 >> 32], axis=-1)  # sign-kept
    gate2 = association_gate * association_gate
    neighbors = np.full((n_cells, 9), -1, np.int64)
    col = 0
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            nk = ((cell_xy[:, 0] + ox) << 32) ^ ((cell_xy[:, 1] + oy)
                                                 & 0xFFFFFFFF)
            pos = np.searchsorted(uniq, nk)
            pos_c = np.minimum(pos, n_cells - 1)
            hit = (uniq[pos_c] == nk) & (
                np.sum((cent - cent[pos_c]) ** 2, axis=-1) <= gate2)
            neighbors[:, col] = np.where(hit, pos_c, np.arange(n_cells))
            col += 1
    label = np.arange(n_cells)
    for _ in range(64):            # chains longer than 64 cells don't occur
        new = np.minimum(label, label[neighbors].min(axis=1))
        # pointer jumping doubles convergence speed on chains
        new = new[new]
        if np.array_equal(new, label):
            break
        label = new
    assign = label[inv]

    # compact to first-observation order, cap capacity, recompute centroids
    used, assign_local = np.unique(assign, return_inverse=True)
    first_obs = np.full(len(used), f, np.int64)
    np.minimum.at(first_obs, assign_local, np.arange(f))
    rank_of = np.empty(len(used), np.int64)
    rank_of[np.argsort(first_obs, kind="stable")] = np.arange(len(used))
    lm_of_obs = rank_of[assign_local]

    keep = lm_of_obs < max_landmarks
    n_lm = int(min(len(used), max_landmarks))
    lm_sums = np.zeros((n_lm, 2))
    np.add.at(lm_sums, lm_of_obs[keep], w[keep])
    lm_counts = np.bincount(lm_of_obs[keep], minlength=n_lm).astype(np.float64)
    landmarks = lm_sums / np.maximum(lm_counts, 1.0)[:, None]
    # zero capacity-dropped ids (masked by ``keep`` downstream) so no
    # out-of-range slot index ever reaches shard_of = obs_lm // per_shard_l,
    # matching _associate_by_ids
    lm_of_obs = np.where(keep, lm_of_obs, 0)
    return landmarks, lm_of_obs.astype(np.int32), keep


def _greedy_associate(
    kf: np.ndarray,
    obs_kf: np.ndarray,
    obs_rb: np.ndarray,
    association_gate: float,
    max_landmarks: int,
):
    """World-project each observation from its keyframe pose and greedily
    cluster: nearest existing landmark within the gate, else a new landmark.
    Returns (landmarks list, obs_lm [F] int, keep [F] bool)."""
    landmarks: List[np.ndarray] = []
    obs_lm = np.zeros(len(obs_kf), np.int32)
    keep = np.zeros(len(obs_kf), bool)
    for i, (k_idx, (dist, bearing)) in enumerate(zip(obs_kf, obs_rb)):
        wx = kf[k_idx, 0] + dist * np.cos(kf[k_idx, 2] + bearing)
        wy = kf[k_idx, 1] + dist * np.sin(kf[k_idx, 2] + bearing)
        w = np.array([wx, wy])
        j_best, d_best = -1, association_gate
        for j, lm in enumerate(landmarks):
            d = float(np.linalg.norm(lm - w))
            if d < d_best:
                j_best, d_best = j, d
        if j_best < 0:
            if len(landmarks) >= max_landmarks:
                continue
            j_best = len(landmarks)
            landmarks.append(w.copy())
        else:
            # running average refines the initial estimate
            landmarks[j_best] = 0.5 * (landmarks[j_best] + w)
        obs_lm[i] = j_best
        keep[i] = True
    return landmarks, obs_lm, keep


def _associate_by_ids(
    kf: np.ndarray,
    obs_kf: np.ndarray,
    obs_rb: np.ndarray,
    track_ids: np.ndarray,
    max_landmarks: int,
):
    """Landmark identity from persistent tracker ids: one graph landmark per
    distinct id (first-seen order), initialized at the mean of that id's
    world-projected observations.  Vectorized (O(F log F)); same return
    contract as _greedy_associate."""
    f = len(obs_kf)
    obs_lm = np.zeros(f, np.int32)
    keep = np.zeros(f, bool)
    tid = np.asarray(track_ids, np.int64)
    valid = tid >= 0
    if not valid.any():
        return np.zeros((0, 2)), obs_lm, keep

    w = _world_project(kf, obs_kf, obs_rb)
    uniq, inv = np.unique(tid[valid], return_inverse=True)
    # first-seen order, like the sequential pass numbered them
    first_obs = np.full(len(uniq), f, np.int64)
    np.minimum.at(first_obs, inv, np.flatnonzero(valid))
    rank_of = np.empty(len(uniq), np.int64)
    rank_of[np.argsort(first_obs, kind="stable")] = np.arange(len(uniq))
    lm_of_valid = rank_of[inv]

    kept_valid = lm_of_valid < max_landmarks
    n_lm = int(min(len(uniq), max_landmarks))
    sums = np.zeros((n_lm, 2))
    np.add.at(sums, lm_of_valid[kept_valid], w[valid][kept_valid])
    counts = np.bincount(lm_of_valid[kept_valid], minlength=n_lm)
    landmarks = sums / np.maximum(counts, 1)[:, None]

    obs_lm[valid] = lm_of_valid.astype(np.int32)
    keep[valid] = kept_valid
    obs_lm[~keep] = 0
    return landmarks, obs_lm, keep


def reinit_landmarks(
    graph: PoseGraph,
    optimized_poses: np.ndarray,
) -> PoseGraph:
    """Identity-preserving landmark re-initialization from optimized poses.

    The tracking-mode analog of :func:`reassociate_pose_graph`: landmark
    *identities* (``obs_lm``) are already right — they came from the
    persistent corner tracker — but the landmark *positions* were initialized
    by world-projecting observations from the drifted input trajectory, which
    under heavy drift leaves the optimizer in a local minimum.  Re-projecting
    every factor from the optimized poses and re-averaging per landmark gives
    the next round a consistent initialization.  Odometry factors, the prior,
    and all factor payloads are unchanged.
    """
    kf = _host(optimized_poses).astype(np.float64)
    valid = _host(graph.obs_valid)
    obs_kf = _host(graph.obs_kf)
    obs_lm = _host(graph.obs_lm)
    obs_rb = _host(graph.obs_rb).astype(np.float64)
    max_landmarks = graph.landmarks.shape[0]

    sums = np.zeros((max_landmarks, 2))
    counts = np.zeros(max_landmarks)
    idx = np.flatnonzero(valid)
    w = _world_project(kf, obs_kf[idx], obs_rb[idx])
    np.add.at(sums, obs_lm[idx], w)
    np.add.at(counts, obs_lm[idx], 1.0)

    lm_arr = _host(graph.landmarks).astype(np.float64)
    seen = counts > 0
    lm_arr[seen] = sums[seen] / counts[seen, None]

    device = graph.poses.device
    return graph._replace(
        poses=_f32(kf, device),
        landmarks=_f32(lm_arr, device),
    )


def _associate(kf, obs_kf, obs_rb, gate, max_landmarks, association):
    """Dispatch: exact greedy for small windows, grid hash at scale."""
    if association == "auto":
        association = "grid" if len(obs_kf) > _GRID_THRESHOLD else "greedy"
    if association == "grid":
        return _grid_associate(kf, obs_kf, obs_rb, gate, max_landmarks)
    if association == "greedy":
        return _greedy_associate(kf, obs_kf, obs_rb, gate, max_landmarks)
    raise ValueError(f"association must be auto|greedy|grid, got {association}")


def reassociate_pose_graph(
    graph: PoseGraph,
    optimized_poses: np.ndarray,
    *,
    association_gate: float = 0.8,
    association: str = "auto",
) -> PoseGraph:
    """Joint re-association: redo landmark data association from OPTIMIZED
    keyframe poses.

    The initial greedy association runs at the drifted input poses, so under
    heavy drift one physical corner splits into several graph landmarks and
    the optimizer cannot close the loop across them.  After a Gauss-Newton
    round the poses are better; re-projecting every observation factor from
    the optimized poses and re-clustering merges those duplicates, giving the
    next optimization round the loop-closure constraints the first one was
    missing.  Odometry factors, the prior, and the factor (keyframe, range,
    bearing) payloads are unchanged — only landmark identities move.
    """
    kf = _host(optimized_poses).astype(np.float64)
    valid = _host(graph.obs_valid)
    obs_kf = _host(graph.obs_kf)
    obs_rb = _host(graph.obs_rb).astype(np.float64)
    max_landmarks = graph.landmarks.shape[0]

    idx = np.flatnonzero(valid)
    landmarks, lm_ids, keep = _associate(
        kf, obs_kf[idx], obs_rb[idx], association_gate, max_landmarks,
        association,
    )

    obs_lm_arr = _host(graph.obs_lm).copy()
    obs_valid_arr = valid.copy()
    obs_lm_arr[idx] = lm_ids
    obs_valid_arr[idx] = keep

    lm_arr = np.zeros((max_landmarks, 2), np.float32)
    if len(landmarks):
        lm_arr[: len(landmarks)] = np.asarray(landmarks, np.float32)
    lm_valid = np.zeros(max_landmarks, bool)
    lm_valid[: len(landmarks)] = True

    device = graph.poses.device
    return graph._replace(
        poses=_f32(kf, device),
        landmarks=_f32(lm_arr, device),
        lm_valid=torch.from_numpy(lm_valid).to(device),
        obs_lm=torch.from_numpy(obs_lm_arr).to(device),
        obs_valid=torch.from_numpy(obs_valid_arr).to(device),
    )


def build_pose_graph(
    keyframe_poses: np.ndarray,
    measurements: Sequence[np.ndarray],
    *,
    measurement_ids: Sequence[np.ndarray] | None = None,
    association_poses: np.ndarray | None = None,
    session_boundaries: Sequence[int] = (),
    association_gate: float = 0.8,
    association: str = "auto",
    max_landmarks: int = 256,
    max_factors: int = 4096,
    odo_sigma_xy: float = 0.05,
    odo_sigma_theta: float = 0.02,
    obs_sigma_r: float = 0.1,
    obs_sigma_b: float = 0.05,
    prior_sigma: float = 1e-3,
    device: torch.device | str = "cuda",
) -> PoseGraph:
    """Assemble a masked fixed-capacity PoseGraph.

    Args:
      keyframe_poses: ``[K, 3]`` initial pose estimates (e.g. filter output).
      measurements: length-K list of ``[m_k, 2]`` (range, bearing) arrays.
      measurement_ids: optional length-K list of ``[m_k]`` persistent corner
        track ids (``frontend/tracking.py``).  When given, landmark identity
        comes from the tracker — two observations share a graph landmark iff
        they share a track id — instead of greedy world-frame clustering,
        which makes loop closures immune to accumulated drift (the tracker
        established identity frame-to-frame when drift was still tiny).
      association_poses: optional ``[K, 3]`` trajectory used ONLY for the
        world-frame clustering projection — typically the output of
        :func:`~fastslam_tpu_torch.backend.alignment.consensus_align`, whose
        drift-corrected frame lets a tight gate merge temporally-distant
        same-landmark observations that would split at the drifted input
        poses.  Odometry factors, graph poses, and landmark initialization
        all still come from ``keyframe_poses`` (landmark positions are
        re-projected from them), so the optimizer starts from the honest
        drifted state with the corrected *identities*.
      session_boundaries: keyframe indices where a NEW session starts (for
        multi-session joint refinement): the odometry factor spanning each
        boundary is invalidated, so independent trajectories are linked only
        through shared landmarks, never by a bogus inter-session "motion".
      device: where the graph's tensors go.
    """
    kf = np.asarray(keyframe_poses, np.float64)
    k = kf.shape[0]

    # odometry factors from consecutive keyframe estimates
    a, b = kf[:-1], kf[1:]
    c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
    dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    odo_rel = np.stack([
        c * dx + s * dy,
        -s * dx + c * dy,
        (b[:, 2] - a[:, 2] + np.pi) % (2 * np.pi) - np.pi,
    ], axis=-1)
    odo_valid = np.ones(k - 1, bool)
    for b in session_boundaries:
        if 0 < b <= k - 1:
            odo_valid[b - 1] = False
    odo_info = np.tile(
        [1.0 / odo_sigma_xy ** 2, 1.0 / odo_sigma_xy ** 2, 1.0 / odo_sigma_theta ** 2],
        (k - 1, 1),
    )

    # landmark association: tracker identity when given, else world-frame
    # clustering (exact greedy small, grid hash at scale — see module doc)
    counts = [np.asarray(m, np.float64).reshape(-1, 2).shape[0]
              for m in measurements]
    all_kf = np.repeat(np.arange(k, dtype=np.int32), counts)
    all_rb = (np.concatenate(
        [np.asarray(m, np.float64).reshape(-1, 2) for m in measurements]
    ) if sum(counts) else np.zeros((0, 2)))

    if measurement_ids is not None:
        all_tid = (np.concatenate(
            [np.asarray(t, np.int64).reshape(-1) for t in measurement_ids]
        ) if sum(counts) else np.zeros(0, np.int64))
        landmarks, lm_ids, kept = _associate_by_ids(
            kf, all_kf, all_rb, all_tid, max_landmarks
        )
    else:
        assoc_kf = (kf if association_poses is None
                    else np.asarray(association_poses, np.float64))
        landmarks, lm_ids, kept = _associate(
            assoc_kf, all_kf, all_rb, association_gate, max_landmarks,
            association
        )
        if association_poses is not None and len(landmarks):
            # identities came from the corrected frame; re-project landmark
            # inits from the REAL keyframe poses so the initial state is
            # internally consistent (drifted poses + drifted landmarks)
            n_lm0 = len(landmarks)
            w = _world_project(kf, all_kf[kept], all_rb[kept])
            sums = np.zeros((n_lm0, 2))
            np.add.at(sums, lm_ids[kept], w)
            cnt = np.bincount(lm_ids[kept], minlength=n_lm0).astype(float)
            landmarks = sums / np.maximum(cnt, 1.0)[:, None]
    obs_kf = all_kf[kept]
    obs_lm = lm_ids[kept]
    obs_rb = all_rb[kept]

    f = min(len(obs_kf), max_factors)
    l = max_landmarks

    lm_arr = np.zeros((l, 2))
    if len(landmarks):
        lm_arr[: len(landmarks)] = np.asarray(landmarks)
    lm_valid = np.zeros(l, bool)
    lm_valid[: len(landmarks)] = True

    obs_kf_arr = np.zeros(max_factors, np.int32)
    obs_lm_arr = np.zeros(max_factors, np.int32)
    obs_rb_arr = np.zeros((max_factors, 2))
    obs_valid = np.zeros(max_factors, bool)
    if f > 0:
        obs_kf_arr[:f] = obs_kf[:f]
        obs_lm_arr[:f] = obs_lm[:f]
        obs_rb_arr[:f] = obs_rb[:f]
        obs_valid[:f] = True
    if len(obs_kf) > max_factors:
        import warnings

        warnings.warn(
            f"build_pose_graph: {len(obs_kf) - max_factors} of "
            f"{len(obs_kf)} observation factors dropped (max_factors="
            f"{max_factors}); raise max_factors to keep them",
            stacklevel=2,
        )
    obs_info = np.tile([1.0 / obs_sigma_r ** 2, 1.0 / obs_sigma_b ** 2],
                       (max_factors, 1))

    as32 = lambda x: _f32(x, device)
    as_is = lambda x: torch.from_numpy(x).to(device)
    return PoseGraph(
        poses=as32(kf),
        landmarks=as32(lm_arr),
        lm_valid=as_is(lm_valid),
        odo_rel=as32(odo_rel),
        odo_info=as32(odo_info),
        odo_valid=as_is(odo_valid),
        obs_kf=as_is(obs_kf_arr),
        obs_lm=as_is(obs_lm_arr),
        obs_rb=as32(obs_rb_arr),
        obs_info=as32(obs_info),
        obs_valid=as_is(obs_valid),
        prior_info=as32(np.full(3, 1.0 / prior_sigma ** 2)),
    )
