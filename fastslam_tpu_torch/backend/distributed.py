"""Distributed pose-graph optimization: Schur complement over a map mesh.

Counterpart of ``fastslam_tpu/backend/distributed.py`` (BASELINE.json config
#5: 1M landmarks in blocks + pose-graph backend via distributed Schur
complement).  The structure (see ``backend/pose_graph.py``):

* landmark slots and their observation factors shard over the map mesh —
  ``landmark_system`` is shard-local (per-landmark 2x2 Hll inverses,
  per-shard Hpl blocks);
* the reduced pose system is small ([3K, 3K] for K keyframes), so each
  shard's partial ``(hpp_diag, bp_obs, cross, rs_corr)`` is summed over the
  mesh and the solve happens once;
* back-substitution of landmark updates is again shard-local.

Where the JAX package runs one program per device under ``shard_map``, the
port's controller loops over the shards in order (``parallel/mesh.py:
MapMesh``; the shards may all lie on one card) and adds their partials with
``parallel/collectives.py:psum``, in shard order on the first shard's
device.  S shards therefore agree with one shard within rounding, and a run
repeats bit for bit.

Factor-to-shard placement: ``shard_pose_graph`` re-buckets the factors so
each lives on the shard owning its landmark (``obs_lm`` stays a global slot
index; the step converts it to the shard's slot).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from fastslam_tpu_torch.backend.builder import _host
from fastslam_tpu_torch.backend.pose_graph import (
    Marks,
    PoseGraph,
    Layouts,
    apply_pose_step,
    backsubstitute_landmarks,
    backsubstitute_landmarks_sparse,
    dense_layout,
    landmark_system,
    landmark_system_sparse,
    pose_system,
    reduced_system,
    solve_pos,
    sparse_layout,
    total_error,
)
from fastslam_tpu_torch.parallel.collectives import all_gather, psum
from fastslam_tpu_torch.parallel.mesh import MapMesh


def shard_pose_graph(g: PoseGraph, num_shards: int) -> Tuple[PoseGraph, int]:
    """Re-bucket landmarks/factors so shard s owns landmark slots
    [s*L/n, (s+1)*L/n) and exactly the factors that observe them.

    Returns ``(graph, dropped)``: a PoseGraph whose factor arrays are
    permutations with per-shard factor capacity ``F/num_shards`` (``obs_lm``
    stays a GLOBAL slot index), on the device of ``g``'s factors, and the
    number of valid factors that did NOT fit their owning shard's capacity.
    ``dropped > 0`` weakens the optimization and warns; rebalance landmark
    slots or raise ``max_factors`` to avoid it.  Host numpy, as the
    reference.
    """
    l = g.landmarks.shape[0]
    f = g.obs_kf.shape[0]
    if l % num_shards or f % num_shards:
        raise ValueError(f"landmark ({l}) and factor ({f}) capacities must divide "
                         f"into {num_shards} shards")
    per_shard_l = l // num_shards
    per_shard_f = f // num_shards

    obs_lm = _host(g.obs_lm)
    obs_valid = _host(g.obs_valid)
    shard_of = obs_lm // per_shard_l

    # bucket factors by owning shard; overflow drops (capacity is static):
    # stable-sort valid factors by shard, then clamp each shard's run
    pad_slot = int(np.argmin(obs_valid)) if not obs_valid.all() else 0
    order = np.full(f, pad_slot, np.int64)
    new_valid = np.zeros(f, bool)
    valid_idx = np.flatnonzero(obs_valid)
    by_shard = valid_idx[np.argsort(shard_of[valid_idx], kind="stable")]
    shard_sizes = np.bincount(shard_of[valid_idx], minlength=num_shards)
    starts = np.concatenate([[0], np.cumsum(shard_sizes)[:-1]])
    taken = np.minimum(shard_sizes, per_shard_f)
    dropped = int(np.sum(shard_sizes - taken))
    for s in range(num_shards):
        n = int(taken[s])
        dst = s * per_shard_f
        order[dst: dst + n] = by_shard[int(starts[s]): int(starts[s]) + n]
        new_valid[dst: dst + n] = True

    if dropped:
        warnings.warn(
            f"shard_pose_graph: {dropped} valid factors overflowed their "
            f"owning shard's capacity ({per_shard_f}/shard) and were "
            "DROPPED — the optimization is weakened; rebalance landmark "
            "slots or raise max_factors",
            stacklevel=2,
        )

    device = g.obs_kf.device
    take = lambda x: torch.from_numpy(np.ascontiguousarray(_host(x)[order])).to(device)
    return g._replace(
        obs_kf=take(g.obs_kf),
        obs_lm=take(obs_lm),
        obs_rb=take(g.obs_rb),
        obs_info=take(g.obs_info),
        obs_valid=torch.from_numpy(new_valid).to(device),
    ), dropped


def build_schur_pairs(g: PoseGraph, num_shards: int, device=None):
    """Ordered same-landmark factor-pair lists for the SPARSE Schur path
    (``pose_graph.landmark_system_sparse``).

    For every landmark with c observing factors the cross term needs all
    c^2 ordered factor pairs.  Host numpy over the ALREADY-SHARDED graph
    (factor slot s*F/n..(s+1)*F/n belongs to shard s): per shard, sort its
    valid factors by landmark id, enumerate pairs within each equal-landmark
    run, pad every shard to the common capacity with masked (0, 0) pairs.

    Returns ``(pair_a, pair_b, pair_valid)`` as ``[n_shards * cap]`` tensors
    of SHARD-LOCAL factor slot indices, on ``device`` (default: the
    graph's).
    """
    f = g.obs_kf.shape[0]
    per_shard_f = f // num_shards
    obs_lm = _host(g.obs_lm)
    obs_valid = _host(g.obs_valid)

    per_shard = []
    for s in range(num_shards):
        lo = s * per_shard_f
        valid = np.flatnonzero(obs_valid[lo: lo + per_shard_f])
        if valid.size == 0:
            per_shard.append((np.zeros(0, np.int32), np.zeros(0, np.int32)))
            continue
        lm = obs_lm[lo + valid]
        order = np.argsort(lm, kind="stable")
        sorted_idx = valid[order].astype(np.int32)
        lm_sorted = lm[order]
        _, counts = np.unique(lm_sorted, return_counts=True)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        c2 = counts * counts
        total = int(c2.sum())
        pair_starts = np.concatenate([[0], np.cumsum(c2)[:-1]])
        base = np.repeat(starts, c2)
        q = np.arange(total) - np.repeat(pair_starts, c2)
        c_rep = np.repeat(counts, c2)
        pa = sorted_idx[base + q // c_rep]
        pb = sorted_idx[base + q % c_rep]
        per_shard.append((pa, pb))

    cap = max(8, max((len(pa) for pa, _ in per_shard), default=8))
    cap = -(-cap // 8) * 8
    pair_a = np.zeros((num_shards, cap), np.int32)
    pair_b = np.zeros((num_shards, cap), np.int32)
    pair_valid = np.zeros((num_shards, cap), bool)
    for s, (pa, pb) in enumerate(per_shard):
        pair_a[s, : len(pa)] = pa
        pair_b[s, : len(pb)] = pb
        pair_valid[s, : len(pa)] = True
    device = g.obs_kf.device if device is None else device
    return tuple(torch.from_numpy(a.reshape(-1)).to(device)
                 for a in (pair_a, pair_b, pair_valid))


def _chunk(t: torch.Tensor, s: int, n: int, device) -> torch.Tensor:
    """Shard ``s``'s ``n`` rows of ``t`` on its device."""
    return t.narrow(0, s * n, n).to(device)


def _local_slots(obs_lm, obs_valid, shard: int, l_local: int) -> torch.Tensor:
    """Global landmark slots -> the shard's own; an invalid factor (which
    may name another shard's slot) takes slot 0, its terms being zero."""
    return torch.where(obs_valid, obs_lm.long() - shard * l_local, 0)


def schur_layouts(mesh: MapMesh, k: int, l: int, obs_kf, obs_lm, obs_valid,
                  pair_a, pair_b, pair_valid) -> List[Layouts]:
    """Each shard's sparse segment layouts (``pose_graph.sparse_layout``)
    for a sharded graph of ``k`` keyframes and ``l`` landmark slots: built
    once per graph, passed to every step."""
    s_n = mesh.num_shards
    l_local, f_local, cap = l // s_n, obs_kf.shape[0] // s_n, pair_a.shape[0] // s_n
    out = []
    for s, dev in enumerate(mesh.devices):
        valid = _chunk(obs_valid, s, f_local, dev)
        local_lm = _local_slots(_chunk(obs_lm, s, f_local, dev), valid, s, l_local)
        out.append(sparse_layout(_chunk(obs_kf, s, f_local, dev), local_lm, valid,
                                 *(_chunk(t, s, cap, dev) for t in (pair_a, pair_b, pair_valid)),
                                 k, l_local))
    return out


def make_sharded_gn_step(mesh: MapMesh, sparse: bool = True):
    """One distributed damped-GN step over ``mesh``.

    Sharding: poses replicated; landmarks + observation factors (and, on
    the sparse path, factor pairs) split into equal contiguous blocks, one
    per shard.  One ``psum`` of [K,3,3]+[K,3]+[K,K,3,3]+[K,3] per step,
    independent of landmark count.

    ``sparse=True`` (default) uses the factor-pair Schur reduction, O(F +
    K^2) memory, and takes the columns ``(poses, lx, ly, odo_rel, odo_info,
    odo_valid, obs_kf, obs_lm, rb0, rb1, w0, w1, obs_valid, prior_info,
    damping, pair_a, pair_b, pair_valid)`` of the reference's step, returning
    ``(poses, lx, ly)``; ``layouts`` (:func:`schur_layouts`) saves building
    them per call.  ``sparse=False`` keeps the dense [K, L] path (small
    maps): ``step(g, damping)`` on a :func:`shard_pose_graph` graph returns
    ``(poses, landmarks)``.  ``marks`` (``utils/profiling.py:EventMarks``),
    when given, ends the stages ``schur``, ``cross`` (sparse), ``solve`` and
    ``backsub``.
    """
    s_n = mesh.num_shards

    def finish(poses, g_odo, damping, partials, marks: Marks):
        hpp_diag, bp_obs, cross, rs_corr = (psum([p[i] for p in partials]) for i in range(4))
        big_h, bp = pose_system(poses, g_odo, damping)
        s_mat, rs = reduced_system(big_h, bp, hpp_diag, bp_obs, cross, rs_corr)
        if marks is not None:
            marks("schur")
        dp = solve_pos(s_mat, rs).to(poses.dtype).reshape(poses.shape[0], 3)
        if marks is not None:
            marks("solve")
        return dp

    def odometry_graph(poses, odo_rel, odo_info, odo_valid, prior_info):
        return PoseGraph(poses=poses, landmarks=None, lm_valid=None, odo_rel=odo_rel,
                         odo_info=odo_info, odo_valid=odo_valid, obs_kf=None, obs_lm=None,
                         obs_rb=None, obs_info=None, obs_valid=None, prior_info=prior_info)

    def sparse_step(poses, lx, ly, odo_rel, odo_info, odo_valid,
                    obs_kf, obs_lm, rb0, rb1, w0, w1, obs_valid,
                    prior_info, damping, pair_a, pair_b, pair_valid, *,
                    layouts: Optional[List[Layouts]] = None, marks: Marks = None):
        k = poses.shape[0]
        l_local, f_local = lx.shape[0] // s_n, obs_kf.shape[0] // s_n
        cap = pair_a.shape[0] // s_n
        if layouts is None:
            layouts = schur_layouts(mesh, k, lx.shape[0], obs_kf, obs_lm, obs_valid,
                                    pair_a, pair_b, pair_valid)
        partials, local = [], []
        for s, dev in enumerate(mesh.devices):
            fc = lambda t: _chunk(t, s, f_local, dev)
            valid = fc(obs_valid)
            kf = fc(obs_kf)
            local_lm = _local_slots(fc(obs_lm), valid, s, l_local)
            lx_s, ly_s = _chunk(lx, s, l_local, dev), _chunk(ly, s, l_local, dev)
            out = landmark_system_sparse(
                poses.to(dev), lx_s, ly_s, damping, kf, local_lm, fc(rb0), fc(rb1), fc(w0),
                fc(w1), valid, *(_chunk(t, s, cap, dev) for t in (pair_a, pair_b, pair_valid)),
                layout=layouts[s], marks=marks)
            partials.append(out[:4])
            local.append((out[4:], kf, local_lm, lx_s, ly_s, layouts[s].by_lm))
        dp = finish(poses, odometry_graph(poses, odo_rel, odo_info, odo_valid, prior_info),
                    damping, partials, marks)
        new_lx, new_ly = [], []
        for dev, ((hll_inv_c, bl_c, hpl_c), kf, local_lm, lx_s, ly_s, by_lm) in zip(
                mesh.devices, local):
            dlx, dly = backsubstitute_landmarks_sparse(
                dp.to(dev), hll_inv_c, bl_c, hpl_c, kf, local_lm, l_local, by_lm)
            new_lx.append(lx_s + dlx)
            new_ly.append(ly_s + dly)
        if marks is not None:
            marks("backsub")
        return apply_pose_step(poses, dp), all_gather(new_lx), all_gather(new_ly)

    def dense_step(g: PoseGraph, damping, *, marks: Marks = None):
        poses = g.poses
        l_local, f_local = g.landmarks.shape[0] // s_n, g.obs_kf.shape[0] // s_n
        partials, local = [], []
        for s, dev in enumerate(mesh.devices):
            fc = lambda t: _chunk(t, s, f_local, dev)
            valid = fc(g.obs_valid)
            landmarks = _chunk(g.landmarks, s, l_local, dev)
            g_local = PoseGraph(
                poses=poses.to(dev), landmarks=landmarks,
                lm_valid=torch.ones(l_local, dtype=torch.bool, device=dev),
                odo_rel=g.odo_rel, odo_info=g.odo_info, odo_valid=g.odo_valid,
                obs_kf=fc(g.obs_kf), obs_lm=_local_slots(fc(g.obs_lm), valid, s, l_local),
                obs_rb=fc(g.obs_rb), obs_info=fc(g.obs_info), obs_valid=valid,
                prior_info=g.prior_info)
            out = landmark_system(g_local.poses, landmarks, g_local, damping,
                                  dense_layout(g_local))
            partials.append(out[:4])
            local.append((out[4:], landmarks))
        dp = finish(poses, g, damping, partials, marks)
        new_l = [lm + backsubstitute_landmarks(dp.to(dev), hll_inv, bl, hpl_dense)
                 for dev, ((hll_inv, bl, hpl_dense), lm) in zip(mesh.devices, local)]
        if marks is not None:
            marks("backsub")
        return apply_pose_step(poses, dp), all_gather(new_l)

    return sparse_step if sparse else dense_step


def total_error_host(poses, lx, ly, g: PoseGraph) -> float:
    """Host-side (NumPy, float64) total_error over column arrays: the
    optimizer's accept/reject error, as the reference evaluates it.  Same
    math as :func:`pose_graph.total_error`; takes tensors or arrays."""
    poses = _host(poses).astype(np.float64)
    lx = _host(lx).astype(np.float64)
    ly = _host(ly).astype(np.float64)
    wrap = lambda a: (a + np.pi) % (2.0 * np.pi) - np.pi
    pa, pb = poses[:-1], poses[1:]
    c, s = np.cos(pa[:, 2]), np.sin(pa[:, 2])
    dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
    odo_rel = _host(g.odo_rel)
    r_odo = np.stack([
        c * dx + s * dy - odo_rel[:, 0],
        -s * dx + c * dy - odo_rel[:, 1],
        wrap(wrap(pb[:, 2] - pa[:, 2]) - odo_rel[:, 2]),
    ], axis=-1)
    w_odo = np.where(_host(g.odo_valid)[:, None], _host(g.odo_info), 0.0)
    obs_kf = _host(g.obs_kf)
    obs_lm = _host(g.obs_lm)
    rb = _host(g.obs_rb).astype(np.float64)
    ddx = lx[obs_lm] - poses[obs_kf, 0]
    ddy = ly[obs_lm] - poses[obs_kf, 1]
    q = np.maximum(ddx * ddx + ddy * ddy, 1e-12)
    r0 = rb[:, 0] - np.sqrt(q)
    r1 = wrap(rb[:, 1] - (np.arctan2(ddy, ddx) - poses[obs_kf, 2]))
    w = np.where(_host(g.obs_valid)[:, None], _host(g.obs_info).astype(np.float64), 0.0)
    return float((r_odo * r_odo * w_odo).sum()
                 + (w[:, 0] * r0 * r0 + w[:, 1] * r1 * r1).sum())


def optimize_sharded(g: PoseGraph, mesh: MapMesh, num_iters: int = 10,
                     damping: float = 1e-6, sparse: bool = True, marks: Marks = None):
    """LM loop over the distributed GN step (host-side accept/reject).

    ``sparse=True`` (default) runs the factor-pair Schur reduction — the
    O(F + K^2)-memory path that handles 1M-landmark graphs — on column
    vectors, with the segment layouts built once, and evaluates the
    accept/reject error on the host (:func:`total_error_host`; ``marks``
    then also ends an ``error`` stage per iteration); ``sparse=False``
    keeps the dense [K, L] assembly (small maps) and the device error.
    Returns ``(poses [K, 3], landmarks [L, 2], err)`` on the mesh's first
    device, the landmarks in the sharded graph's slot order (the same as
    the input's: sharding permutes factors, not slots)."""
    num_shards = mesh.num_shards
    g, _dropped = shard_pose_graph(g, num_shards)
    device = mesh.devices[0]
    step = make_sharded_gn_step(mesh, sparse=sparse)
    f32 = lambda x: x.to(device, torch.float32).contiguous()
    lam = damping
    if sparse:
        pair_a, pair_b, pair_valid = build_schur_pairs(g, num_shards, device)
        cols = dict(
            odo_rel=f32(g.odo_rel), odo_info=f32(g.odo_info),
            odo_valid=g.odo_valid.to(device),
            obs_kf=g.obs_kf.to(device, torch.int32), obs_lm=g.obs_lm.to(device, torch.int32),
            rb0=f32(g.obs_rb[:, 0]), rb1=f32(g.obs_rb[:, 1]),
            w0=f32(g.obs_info[:, 0]), w1=f32(g.obs_info[:, 1]),
            obs_valid=g.obs_valid.to(device), prior_info=f32(g.prior_info),
        )
        layouts = schur_layouts(mesh, g.poses.shape[0], g.landmarks.shape[0],
                                cols["obs_kf"], cols["obs_lm"], cols["obs_valid"],
                                pair_a, pair_b, pair_valid)
        host = PoseGraph(*(None if x is None else _host(x) for x in g))
        poses, lx, ly = f32(g.poses), f32(g.landmarks[:, 0]), f32(g.landmarks[:, 1])
        err = total_error_host(poses, lx, ly, host)
        if marks is not None:
            marks.start()
        for _ in range(num_iters):
            new_p, new_lx, new_ly = step(
                poses, lx, ly, damping=torch.tensor(lam, dtype=torch.float32, device=device),
                pair_a=pair_a, pair_b=pair_b, pair_valid=pair_valid, layouts=layouts,
                marks=marks, **cols)
            new_err = total_error_host(new_p, new_lx, new_ly, host)
            if marks is not None:
                marks("error")
            if np.isfinite(new_err) and new_err < err:
                poses, lx, ly, err, lam = new_p, new_lx, new_ly, new_err, lam * 0.5
            else:
                lam *= 10.0
        return poses, torch.stack([lx, ly], dim=-1), err

    g = PoseGraph(*(x.to(device) for x in g))
    err = float(total_error(g.poses, g.landmarks, g))
    poses, landmarks = g.poses, g.landmarks
    if marks is not None:
        marks.start()
    for _ in range(num_iters):
        new_p, new_l = step(g._replace(poses=poses, landmarks=landmarks),
                            torch.tensor(lam, dtype=torch.float32, device=device),
                            marks=marks)
        new_err = float(total_error(new_p, new_l, g))
        if marks is not None:
            marks("error")
        if new_err < err:
            poses, landmarks, err, lam = new_p, new_l, new_err, lam * 0.5
        else:
            lam *= 10.0
    return poses, landmarks, err
