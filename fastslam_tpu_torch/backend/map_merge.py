"""Multi-session map merge: align and fuse landmark maps across runs.

Counterpart of ``fastslam_tpu/backend/map_merge.py``:

1. :func:`align_landmark_maps` — estimate the SE(2) transform taking session
   B's landmark map into session A's frame with a correspondence-gated
   (trimmed) ICP, robust to partial overlap: correspondences beyond the gate
   get zero weight each iteration, so B-only landmarks cannot bias the fit.
2. :func:`merge_landmark_maps` — fuse the aligned maps: B landmarks within
   the merge gate of an A landmark average into it (scatter-mean), the rest
   append into A's free capacity slots.
3. :func:`merge_sessions` — the end-to-end convenience: align, merge, and
   carry session B's trajectory into the merged frame.
4. :func:`refine_merged_sessions` — one pose graph over both sessions'
   keyframes, so co-observed landmarks bend each trajectory.

What differs from the JAX package: the alignment's ``lax.while_loop`` is a
loop of at most ``num_iters`` iterations in which a converged alignment
keeps its carry (``torch.where``), with the host checking for convergence
every ``_CHECK_EVERY`` iterations (each check is a device-to-host sync), as
``proposal/icp.py`` does; its nearest-neighbour searches are
``proposal/icp.py:nearest_neighbors``, one launch of the ICP search kernel
each on the card.  The merge's scatter-mean is a segment sum
(``core/cuda_kernels/segment_sum.py:segment_sum``), the same on every run, and its
dropping scatter writes into a spare row that is sliced off.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fastslam_tpu_torch.core.cuda_kernels import segment_layout, segment_sum
from fastslam_tpu_torch.proposal.icp import (
    best_fit_angle, nearest_neighbors, rotate_points, rotation_matrix,
)

# host convergence check period of the alignment loop
_CHECK_EVERY = 4


class MapAlignment(NamedTuple):
    rotation: torch.Tensor       # [2, 2] R taking B-frame points to A-frame
    translation: torch.Tensor    # [2]
    mean_residual: torch.Tensor  # mean gated NN distance at convergence
    num_matched: torch.Tensor    # landmarks of B that found a gated match in A


class MergedMap(NamedTuple):
    landmarks: torch.Tensor      # [cap, 2] fused map (A's capacity)
    valid: torch.Tensor          # [cap] bool
    matched_b: torch.Tensor      # [Lb] bool - B landmarks fused into an A landmark
    appended_b: torch.Tensor     # [Lb] bool - B landmarks appended as new
    dropped_b: torch.Tensor      # [Lb] bool - unmatched B landmarks lost to capacity


def transform_points(points: torch.Tensor, rotation: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """Apply an SE(2) transform to ``[N, 2]`` points, elementwise by the
    rotation's angle (not ``points @ R.T``)."""
    theta = torch.atan2(rotation[1, 0], rotation[0, 0])
    return rotate_points(points, theta) + translation


def transform_poses(poses: torch.Tensor, rotation: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """Apply an SE(2) transform to ``[N, 3]`` (x, y, yaw) poses."""
    theta = torch.atan2(rotation[1, 0], rotation[0, 0])
    xy = rotate_points(poses[:, :2], theta) + translation
    yaw = torch.remainder(poses[:, 2] + theta + math.pi, 2.0 * math.pi) - math.pi
    return torch.cat([xy, yaw[:, None]], dim=1)


def align_landmark_maps(
    lm_b: torch.Tensor,
    valid_b: torch.Tensor,
    lm_a: torch.Tensor,
    valid_a: torch.Tensor,
    *,
    gate: float = 1.5,
    final_gate: float = 0.3,
    num_iters: int = 50,
    tolerance: float = 1e-6,
) -> MapAlignment:
    """Gated (trimmed) ICP aligning map B onto map A.

    Every iteration down-weights correspondences beyond the gate to zero; the
    gate anneals geometrically from ``gate`` (capture the offset) to
    ``final_gate`` (drop spurious matches between non-shared landmarks).
    Convergence is not declared while the gate still anneals.  Assumes the
    sessions share an approximate global frame; for arbitrary initial offsets
    seed via ``transform_points`` first.
    """
    dt, dev = lm_b.dtype, lm_b.device
    lm_a = lm_a.contiguous()
    valid_a = valid_a.contiguous()
    sw_base = valid_b.to(dt)
    src = lm_b.contiguous()
    theta_total = torch.zeros((), dtype=dt, device=dev)
    trans_total = torch.zeros((2,), dtype=dt, device=dev)
    prev_err = torch.full((), math.inf, dtype=dt, device=dev)
    err = prev_err
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    for it in range(num_iters):
        if it % _CHECK_EVERY == 0 and it and bool(converged):
            break
        active = ~converged
        # while active the iteration count equals it; anneal slowly: the
        # capture phase must outlast ICP's convergence on the gross offset
        g = max(final_gate, gate * 0.93 ** it)
        dist, idx = nearest_neighbors(src, lm_a, valid_a)
        w = sw_base * (dist < g)
        matched = lm_a[idx.long()]
        theta, trans = best_fit_angle(src, matched, w)
        new_src = rotate_points(src, theta) + trans
        new_trans_total = rotate_points(trans_total, theta) + trans
        new_err = torch.sum(dist * w) / torch.clamp_min(torch.sum(w), 1e-12)
        conv = (torch.abs(prev_err - new_err) < tolerance) & (g <= final_gate * 1.01)
        src = torch.where(active, new_src, src).contiguous()
        trans_total = torch.where(active, new_trans_total, trans_total)
        theta_total = torch.where(active, theta_total + theta, theta_total)
        prev_err = torch.where(active, new_err, prev_err)
        err = prev_err
        converged = torch.where(active, conv, converged)
    dist, _ = nearest_neighbors(src, lm_a, valid_a)
    n_matched = torch.sum((dist < final_gate) & valid_b)
    return MapAlignment(rotation=rotation_matrix(theta_total), translation=trans_total,
                        mean_residual=err, num_matched=n_matched)


def merge_landmark_maps(
    lm_a: torch.Tensor,
    valid_a: torch.Tensor,
    lm_b: torch.Tensor,
    valid_b: torch.Tensor,
    *,
    gate: float = 0.5,
    weight_a: float = 1.0,
) -> MergedMap:
    """Fuse an ALIGNED map B into map A (masked, fixed shapes, no host sync).

    B landmarks within ``gate`` of their nearest valid A landmark
    average into it (``weight_a`` is A's prior weight — e.g. its session
    count); the rest append into A's free slots, and report as dropped once
    capacity is exhausted.

    NOTE: the output slot order is NOT stable relative to ``lm_a`` — A's
    valid landmarks are compacted to the front (so free slots are contiguous
    for the appends) before B is scattered in.  ``matched_b``/``appended_b``/
    ``dropped_b`` index rows of ``lm_b``, which IS stable.
    """
    cap = lm_a.shape[0]
    dist, idx = nearest_neighbors(lm_b.contiguous(), lm_a.contiguous(), valid_a.contiguous())
    matched = valid_b & (dist < gate)

    # scatter-mean matched B landmarks into their A slot: one segment sum of
    # (1, x, y) over the matched B landmarks of each A slot
    ones = matched.to(lm_a.dtype)
    sums = segment_sum(torch.stack([ones, lm_b[:, 0] * ones, lm_b[:, 1] * ones]),
                       segment_layout(idx, matched, cap)).to(lm_a.dtype)
    counts = sums[0]
    denom = (weight_a + counts)[:, None]
    fused = (lm_a * weight_a + sums[1:].T) / torch.clamp_min(denom, 1e-12)
    new_a = torch.where((counts > 0)[:, None], fused, lm_a)

    # append unmatched B landmarks at the free slots after A's valid ones
    n_a = torch.sum(valid_a.to(torch.int32))
    to_append = valid_b & ~matched
    order = torch.cumsum(to_append.to(torch.int32), dim=0) - 1
    slot = n_a + order
    in_cap = to_append & (slot < cap)
    # non-appends write the spare row ``cap``, which is sliced off
    slot_safe = torch.where(in_cap, slot, cap).long()
    a_order = torch.sort((~valid_a).to(torch.int32), stable=True).indices
    new_a = torch.cat([new_a[a_order], new_a.new_zeros((1, 2))])
    new_a[slot_safe] = lm_b
    flags = torch.cat([valid_a[a_order], valid_a.new_zeros(1)])
    flags[slot_safe] = True
    return MergedMap(
        landmarks=new_a[:cap],
        valid=flags[:cap],
        matched_b=matched,
        appended_b=in_cap,
        dropped_b=to_append & ~in_cap,
    )


def merge_sessions(
    lm_a: torch.Tensor,
    valid_a: torch.Tensor,
    lm_b: torch.Tensor,
    valid_b: torch.Tensor,
    poses_b: Optional[torch.Tensor] = None,
    *,
    align_gate: float = 1.5,
    merge_gate: float = 0.5,
    weight_a: float = 1.0,
    num_iters: int = 50,
) -> Tuple[MapAlignment, MergedMap, Optional[torch.Tensor]]:
    """Align session B's map onto session A's and fuse them.

    Returns ``(alignment, merged_map, poses_b_in_a_frame)``; the last is
    ``None`` when ``poses_b`` is not given.
    """
    alignment = align_landmark_maps(lm_b, valid_b, lm_a, valid_a, gate=align_gate,
                                    num_iters=num_iters)
    lm_b_aligned = transform_points(lm_b, alignment.rotation, alignment.translation)
    merged = merge_landmark_maps(lm_a, valid_a, lm_b_aligned, valid_b,
                                 gate=merge_gate, weight_a=weight_a)
    poses_out = None
    if poses_b is not None:
        poses_out = transform_poses(poses_b, alignment.rotation, alignment.translation)
    return alignment, merged, poses_out


def refine_merged_sessions(
    kf_a,
    measurements_a,
    kf_b_aligned,
    measurements_b,
    *,
    num_iters: int = 25,
    reassociate_rounds: int = 2,
    association_gate: float = 0.8,
    max_landmarks: int = 256,
    max_factors: int = 4096,
    consensus: bool = True,
    consensus_sigma_xy: float = 0.05,
    consensus_sigma_theta: float = 0.001,
    device: torch.device | str = "cuda",
):
    """Joint pose-graph refinement of two merged sessions.

    The map-level merge aligns B onto A with one rigid SE(2) transform — it
    cannot correct the sessions' own accumulated drift.  This builds ONE
    pose graph over both trajectories: all keyframes of A then B (B already
    in A's frame), per-session odometry chains (the odometry factor across
    the session boundary is invalidated), and a shared landmark set
    associated in the common frame, so co-observed landmarks become the
    cross-session loop-closure constraints.

    Args:
      kf_a / kf_b_aligned: ``[Ka, 3]`` / ``[Kb, 3]`` keyframe poses, common frame.
      measurements_a / measurements_b: per-keyframe ``[m, 2]`` (range, bearing).
      consensus: associate at the poses of a boundary-aware co-visibility
        consensus alignment (``backend/alignment.py:consensus_align`` with
        ``session_boundaries=(Ka,)``); the graph still starts from the input
        poses.
      device: where the graph is optimized.

    Returns ``(kf_a_refined, kf_b_refined, info)`` (numpy poses).
    """
    from fastslam_tpu_torch.backend.builder import build_pose_graph, reassociate_pose_graph
    from fastslam_tpu_torch.backend.pose_graph import optimize

    kf_a = np.asarray(kf_a, np.float64)
    kf_b = np.asarray(kf_b_aligned, np.float64)
    ka = len(kf_a)
    kf = np.concatenate([kf_a, kf_b], axis=0)
    ms = list(measurements_a) + list(measurements_b)

    assoc_kf = None
    if consensus:
        from fastslam_tpu_torch.backend.alignment import consensus_align

        assoc_kf, _ainfo = consensus_align(
            kf, ms, sigma_xy=consensus_sigma_xy, sigma_theta=consensus_sigma_theta,
            session_boundaries=(ka,))

    graph = build_pose_graph(
        kf, ms, session_boundaries=(ka,), association_poses=assoc_kf,
        association_gate=association_gate, max_landmarks=max_landmarks,
        max_factors=max_factors, device=device)
    poses, landmarks, err, _ = optimize(graph, num_iters=num_iters)

    rounds_used = 0
    per_factor = lambda e, g: float(e) / max(int(g.obs_valid.sum()), 1)
    for _ in range(reassociate_rounds):
        g2 = reassociate_pose_graph(graph, poses, association_gate=association_gate)
        p2, l2, e2, _ = optimize(g2, num_iters=num_iters)
        if per_factor(e2, g2) < per_factor(err, graph):
            graph, poses, landmarks, err = g2, p2, l2, e2
            rounds_used += 1
        else:
            break

    poses = poses.cpu().numpy()
    info = {
        "final_error": float(err),
        "num_landmarks": int(graph.lm_valid.sum()),
        "num_factors": int(graph.obs_valid.sum()),
        "reassociation_rounds": rounds_used,
    }
    return poses[:ka], poses[ka:], info
