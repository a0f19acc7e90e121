"""Pose-graph / bundle-adjustment backend over keyframes.

Counterpart of ``fastslam_tpu/backend/pose_graph.py``, with the same
variables, factors and solver:

Variables
  poses      [K, 3]   keyframe (x, y, theta)
  landmarks  [L, 2]   world-frame landmark positions (masked capacity)

Factors (all masked fixed-capacity)
  prior on pose 0                         anchors the gauge
  odometry   [K-1]    relative SE(2) between consecutive keyframes
  observation [F]     (range, bearing) from keyframe k to landmark j

Solver: damped Gauss-Newton (Levenberg-Marquardt) on the normal equations
with landmark elimination via the Schur complement:

  S  = Hpp - Hpl Hll^-1 Hpl'          (reduced pose system, 3K x 3K dense)
  rs = bp  - Hpl Hll^-1 bl
  dp = solve(S, rs);   dl = Hll^-1 (bl - Hpl' dp)

Hll is block-diagonal 2x2 per landmark (closed-form inverse), so landmarks
and their factors shard over a map mesh (``backend/distributed.py``).

What differs from the JAX package:

* Every float scatter-add of the reference (``.at[idx].add``) is a segment
  sum through a CSR layout (``core/cuda_kernels/segment_sum.py:segment_sum``, one launch
  of the hand-written kernel on the card, its plain version on the CPU),
  which adds in one fixed order: a float ``index_add_`` on the card adds in
  the order its atomics land, and the backend's runs repeat bit for bit.
  The layouts depend only on the graph's structure, so :func:`optimize`
  and ``distributed.optimize_sharded`` build them once
  (:func:`dense_layout`, :func:`sparse_layout`); a function given none
  builds its own.  Invalid factors belong to no segment (their terms are
  zero in the reference).
* The sums accumulate in float64, and the reduced system ``S = Hpp -
  cross`` is assembled and solved in float64 (the reference: float32); the
  per-factor terms, the landmark blocks and the states stay float32.  S is
  the difference of sums of terms up to ~1e9 that cancel, so a float32
  keyframe sum split over S shards and added by ``psum`` rounds otherwise
  than the same sum on one shard, and the solve magnifies that; in float64
  a step on S shards equals the step on one shard to the last float32 bit
  on the surveys the tests and the smoke run use.
* The odometry chain of :func:`pose_system` (block k takes factors k - 1
  and k) is a shifted add, with no scatter.
* The solve is ``torch.linalg.cholesky_ex`` + ``cholesky_solve`` of the
  matrix's upper triangle, as ``jax.scipy.linalg.solve(assume_a="pos")``
  factors it; a matrix that is not positive definite gives a NaN step on the
  device (JAX's factorisation fills NaNs), which :func:`optimize` rejects,
  with no host sync.
* :func:`optimize` is a fixed-length loop with ``torch.where``
  accept/reject on the device, JAX's ``lax.scan``.
* ``atan2`` is evaluated in float64 and rounded once
  (``core/kernels.py:_atan2_f64``): torch's float32 ``atan2`` on the CPU
  depends on the length of the tensor.
* The small per-factor contractions (3x3, 3x2, 2x2) are written out as
  products and sums; the dense path's contractions over landmarks stay
  matrix products (``torch.einsum``; float32 matmuls on the card run in
  full float32 unless a caller turns TF32 on).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from fastslam_tpu_torch.core.cuda_kernels import Segments, segment_layout, segment_sum
from fastslam_tpu_torch.core.kernels import _atan2_f64

# a stage mark: called with a stage's name where the stage ends (see
# utils/profiling.py:EventMarks)
Marks = Optional[Callable[[str], None]]


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Angles into [-pi, pi): ``torch.remainder`` takes the sign of the
    divisor, as ``%`` does in ``jnp`` (``torch.fmod`` would not)."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


class PoseGraph(NamedTuple):
    """Problem data; all capacities static, masked."""

    poses: torch.Tensor        # [K, 3] initial keyframe poses
    landmarks: torch.Tensor    # [L, 2] initial landmark estimates
    lm_valid: torch.Tensor     # [L] bool

    odo_rel: torch.Tensor      # [K-1, 3] relative (dx, dy, dtheta) in frame of k
    odo_info: torch.Tensor     # [K-1, 3] diagonal information (1/sigma^2)
    odo_valid: torch.Tensor    # [K-1] bool

    obs_kf: torch.Tensor       # [F] int32 keyframe index
    obs_lm: torch.Tensor       # [F] int32 landmark index
    obs_rb: torch.Tensor       # [F, 2] (range, bearing)
    obs_info: torch.Tensor     # [F, 2] diagonal information
    obs_valid: torch.Tensor    # [F] bool

    prior_info: torch.Tensor   # [3] information anchoring pose 0


class Layouts(NamedTuple):
    """The segment layouts of a graph's sums: valid factors by keyframe and
    by landmark slot, and by cell — on the dense path valid factors by
    (keyframe, landmark) ``kf * L + lm``, on the sparse path valid factor
    pairs by keyframe pair ``kf_a * K + kf_b`` (``K^2`` segments)."""

    by_kf: Segments
    by_lm: Segments
    by_cell: Segments


def dense_layout(g: PoseGraph) -> Layouts:
    k, l = g.poses.shape[0], g.landmarks.shape[0]
    cell = g.obs_kf.long() * l + g.obs_lm.long()
    return Layouts(segment_layout(g.obs_kf, g.obs_valid, k),
                   segment_layout(g.obs_lm, g.obs_valid, l),
                   segment_layout(cell, g.obs_valid, k * l))


def sparse_layout(obs_kf, obs_lm, obs_valid, pair_a, pair_b, pair_valid,
                  k: int, l: int) -> Layouts:
    """The sparse path's layouts for ``k`` keyframes and ``l`` landmark
    slots (``obs_lm`` the slot within those ``l``)."""
    kf = obs_kf.long()
    cell = kf[pair_a.long()] * k + kf[pair_b.long()]
    return Layouts(segment_layout(obs_kf, obs_valid, k),
                   segment_layout(obs_lm, obs_valid, l),
                   segment_layout(cell, pair_valid, k * k))


# ---------------------------------------------------------------------------
# residuals + analytic Jacobians
# ---------------------------------------------------------------------------

def _odo_residuals(poses, g: PoseGraph):
    """Relative-pose residuals r_k = T_k^{-1} T_{k+1} (-) z_k, [K-1, 3]."""
    pa = poses[:-1]
    pb = poses[1:]
    c = torch.cos(pa[:, 2])
    s = torch.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    rx = c * dx + s * dy
    ry = -s * dx + c * dy
    rt = wrap_angle(pb[:, 2] - pa[:, 2])
    r = torch.stack(
        [rx - g.odo_rel[:, 0], ry - g.odo_rel[:, 1], wrap_angle(rt - g.odo_rel[:, 2])],
        dim=-1)
    return r, (c, s, dx, dy)


def _obs_residuals(poses, landmarks, g: PoseGraph):
    """Range/bearing residuals [F, 2] and geometry terms."""
    pk = poses[g.obs_kf.long()]
    lw = landmarks[g.obs_lm.long()]
    dx = lw[:, 0] - pk[:, 0]
    dy = lw[:, 1] - pk[:, 1]
    q = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    r = torch.sqrt(q)
    pred_b = _atan2_f64(dy, dx) - pk[:, 2]
    res = torch.stack([g.obs_rb[:, 0] - r, wrap_angle(g.obs_rb[:, 1] - pred_b)], dim=-1)
    return res, (dx, dy, q, r)


def _contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum("fij,fik->fjk")`` over a short axis i, as products and
    sums in order of i."""
    out = a[:, 0, :, None] * b[:, 0, None, :]
    for i in range(1, a.shape[1]):
        out = out + a[:, i, :, None] * b[:, i, None, :]
    return out


def _contract_vec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("fij,fi->fj")`` over a short axis i."""
    out = a[:, 0, :] * v[:, 0, None]
    for i in range(1, a.shape[1]):
        out = out + a[:, i, :] * v[:, i, None]
    return out


# ---------------------------------------------------------------------------
# normal equations with Schur elimination
# ---------------------------------------------------------------------------

def pose_system(poses, g: PoseGraph, damping):
    """Pose-only normal-equation part: odometry + prior + damping.

    Returns (big_h [K, K, 3, 3], bp [K, 3]).  Reads only the odometry
    fields and ``prior_info`` of ``g``.  Block k of the chain takes factor
    k's ``haa`` and factor k - 1's ``hbb``: two shifted copies added."""
    k = poses.shape[0]
    r_odo, (c, s, dx, dy) = _odo_residuals(poses, g)
    w_odo = torch.where(g.odo_valid[:, None], g.odo_info, 0.0)

    # Jacobian of r wrt pose a: [[-c, -s, -s*dx + c*dy], [s, -c, -c*dx - s*dy],
    # [0, 0, -1]]; wrt pose b: [[c, s, 0], [-s, c, 0], [0, 0, 1]]
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    ja = torch.stack([
        torch.stack([-c, -s, -s * dx + c * dy], -1),
        torch.stack([s, -c, -c * dx - s * dy], -1),
        torch.stack([zeros, zeros, -ones], -1),
    ], dim=1)
    jb = torch.stack([
        torch.stack([c, s, zeros], -1),
        torch.stack([-s, c, zeros], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=1)

    wja = ja * w_odo[:, :, None]
    wjb = jb * w_odo[:, :, None]
    haa = _contract(ja, wja)
    hbb = _contract(jb, wjb)
    hab = _contract(ja, wjb)
    ba = -_contract_vec(wja, r_odo)
    bb = -_contract_vec(wjb, r_odo)

    pad = torch.nn.functional.pad
    diag = pad(haa, (0, 0, 0, 0, 0, 1)) + pad(hbb, (0, 0, 0, 0, 1, 0))
    diag[0] = diag[0] + torch.diag(g.prior_info)
    diag = diag + damping * torch.eye(3, dtype=poses.dtype, device=poses.device)
    idx = torch.arange(k, device=poses.device)
    big_h = torch.zeros((k, k, 3, 3), dtype=poses.dtype, device=poses.device)
    big_h[idx, idx] = diag
    big_h[idx[:-1], idx[1:]] = hab
    big_h[idx[1:], idx[:-1]] = hab.transpose(1, 2)
    bp = pad(ba, (0, 0, 0, 1)) + pad(bb, (0, 0, 1, 0))
    return big_h, bp


def _inv2x2_sym(ha, hb, hd):
    """Closed-form inverse (ia, ib, id) of symmetric 2x2s; a block whose
    determinant is not above 1e-12 (unobserved) inverts to zero."""
    det = ha * hd - hb * hb
    observed = det > 1e-12
    inv_det = torch.where(observed, 1.0 / torch.where(observed, det, 1.0), 0.0)
    return hd * inv_det, -hb * inv_det, ha * inv_det


def landmark_system(poses, landmarks, g: PoseGraph, damping,
                    layout: Optional[Layouts] = None):
    """Landmark/observation normal-equation part + Schur reduction terms,
    with the dense ``[K, L, 3, 2]`` Hpl assembly (small maps).

    Returns ``(hpp_diag, bp_obs, cross, rs_corr, hll_inv, bl, hpl_dense)``:
    the first four are partial sums under map sharding, the last three stay
    local for back-substitution.  Three segment sums (by keyframe, by
    landmark, by cell)."""
    k = poses.shape[0]
    l = landmarks.shape[0]
    if layout is None:
        layout = dense_layout(g)

    r_obs, (odx, ody, q, rr) = _obs_residuals(poses, landmarks, g)
    w_obs = torch.where(g.obs_valid[:, None], g.obs_info, 0.0)
    jl = torch.stack([
        torch.stack([odx / rr, ody / rr], -1),
        torch.stack([-ody / q, odx / q], -1),
    ], dim=1)                                                      # [F, 2, 2]
    fzeros = torch.zeros_like(rr)
    jp = torch.stack([
        torch.stack([-odx / rr, -ody / rr, fzeros], -1),
        torch.stack([ody / q, -odx / q, -torch.ones_like(rr)], -1),
    ], dim=1)                                                      # [F, 2, 3]
    wjl = jl * w_obs[:, :, None]
    wjp = jp * w_obs[:, :, None]

    # r = z - pred and jl/jp are d(pred)/dx: the system is (J' W J) d = +J' W r
    hpp_f = _contract(jp, wjp)          # [F, 3, 3]
    hll_f = _contract(jl, wjl)          # [F, 2, 2]
    hpl_f = _contract(wjp, jl)          # [F, 3, 2]
    bp_f = _contract_vec(wjp, r_obs)    # [F, 3]
    bl_f = _contract_vec(wjl, r_obs)    # [F, 2]

    f = hpp_f.shape[0]
    kf_sums = segment_sum(torch.cat([hpp_f.reshape(f, 9), bp_f], 1).T.contiguous(),
                          layout.by_kf)
    hpp_diag = kf_sums[:9].T.reshape(k, 3, 3)     # float64, as the reduced system
    bp_obs = kf_sums[9:].T
    lm_sums = segment_sum(torch.cat([hll_f.reshape(f, 4), bl_f], 1).T.contiguous(),
                          layout.by_lm).to(r_obs.dtype)
    hll = lm_sums[:4].T.reshape(l, 2, 2)
    bl = lm_sums[4:].T.contiguous()
    hll = hll + damping * torch.eye(2, dtype=hll.dtype, device=hll.device)

    # closed-form 2x2 inverse (unobserved -> zero influence)
    a, b, c2, d = hll[:, 0, 0], hll[:, 0, 1], hll[:, 1, 0], hll[:, 1, 1]
    det = a * d - b * c2
    observed = det > 1e-12
    inv_det = torch.where(observed, 1.0 / torch.where(observed, det, 1.0), 0.0)
    hll_inv = torch.stack([
        torch.stack([d, -b], -1), torch.stack([-c2, a], -1),
    ], dim=1) * inv_det[:, None, None]

    hpl_dense = segment_sum(hpl_f.reshape(f, 6).T.contiguous(), layout.by_cell
                            ).to(r_obs.dtype).T.reshape(k, l, 3, 2)
    ghl_dense = (hpl_dense[..., :, 0, None] * hll_inv[None, :, None, 0, :]
                 + hpl_dense[..., :, 1, None] * hll_inv[None, :, None, 1, :])
    cross = torch.einsum("klpb,mlqb->kmpq", ghl_dense, hpl_dense)
    rs_corr = torch.einsum("klpb,lb->kp", ghl_dense, bl)
    return hpp_diag, bp_obs, cross, rs_corr, hll_inv, bl, hpl_dense


def _obs_geometry_cols(poses, lx, ly, obs_kf, obs_lm, rb0, rb1):
    """Per-factor residuals + geometry as column vectors ([F] each): the
    reference's struct-of-planes layout, kept so that every per-factor
    quantity is one contiguous column the segment sums read."""
    kf = obs_kf.long()
    lm = obs_lm.long()
    px = poses[:, 0][kf]
    py = poses[:, 1][kf]
    pt = poses[:, 2][kf]
    dx = lx[lm] - px
    dy = ly[lm] - py
    q = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    rr = torch.sqrt(q)
    r0 = rb0 - rr
    r1 = wrap_angle(rb1 - (_atan2_f64(dy, dx) - pt))
    return r0, r1, dx, dy, q, rr


def _assemble_sym3(a00, a01, a02, a11, a12, a22):
    """Six summed symmetric-3x3 component columns ``[K]`` -> ``[K, 3, 3]``."""
    return torch.stack([
        torch.stack([a00, a01, a02], -1),
        torch.stack([a01, a11, a12], -1),
        torch.stack([a02, a12, a22], -1),
    ], dim=1)


def landmark_system_sparse(poses, lx, ly, damping,
                           obs_kf, obs_lm, rb0, rb1, w0, w1, obs_valid,
                           pair_a, pair_b, pair_valid,
                           layout: Optional[Layouts] = None, marks: Marks = None):
    """Factor-sparse Schur reduction: the math of :func:`landmark_system`
    with the dense ``[K, L, 3, 2]`` assembly replaced by per-factor sums, so
    memory is O(F + K^2) instead of O(K*L).

    ``cross[k, m] = sum_l (sum_{f1 in l, kf=k} Hpl_f1) Hll_l^-1
    (sum_{f2 in l, kf=m} Hpl_f2)^T`` is a sum over the ORDERED pairs of
    factors observing the same landmark, ``(pair_a, pair_b, pair_valid)``
    (``distributed.build_schur_pairs``), grouped by keyframe cell.

    Three segment sums: five columns by landmark (Hll, bl), twelve by
    keyframe (Hpp, bp, the rs correction), nine by cell (the cross term).
    ``marks``, when given, is called with ``"schur"`` after the first two
    and ``"cross"`` after the third.

    Returns ``(hpp_diag [K,3,3], bp_obs [K,3], cross [K,K,3,3],
    rs_corr [K,3], hll_inv_c (ia, ib, id) [L] each, bl_c (bl0, bl1),
    hpl_c (6 x [F] — components (p, a), p-major))``.
    """
    k = poses.shape[0]
    l = lx.shape[0]
    if layout is None:
        layout = sparse_layout(obs_kf, obs_lm, obs_valid, pair_a, pair_b, pair_valid, k, l)

    r0, r1, dx, dy, q, rr = _obs_geometry_cols(poses, lx, ly, obs_kf, obs_lm, rb0, rb1)
    v = obs_valid.to(r0.dtype)
    wr = v * w0
    wb = v * w1

    # landmark Jacobian rows: range (l00, l01), bearing (l10, l11); pose
    # Jacobian rows: range (-l00, -l01, 0), bearing (-l10, -l11, -1)
    l00 = dx / rr
    l01 = dy / rr
    l10 = -dy / q
    l11 = dx / q

    # Hpp_f (symmetric), bp_f, and the per-landmark Hll_f, bl_f
    h00 = wr * l00 * l00 + wb * l10 * l10
    h01 = wr * l00 * l01 + wb * l10 * l11
    h02 = wb * l10
    h11 = wr * l01 * l01 + wb * l11 * l11
    h12 = wb * l11
    h22 = wb
    wr0 = wr * r0
    wb1 = wb * r1
    bl_f0 = wr0 * l00 + wb1 * l10
    bl_f1 = wr0 * l01 + wb1 * l11

    lm_sums = segment_sum(torch.stack([h00, h01, h11, bl_f0, bl_f1]),
                          layout.by_lm).to(r0.dtype)
    ha = lm_sums[0] + damping
    hb = lm_sums[1]
    hd = lm_sums[2] + damping
    bl0, bl1 = lm_sums[3], lm_sums[4]
    ia, ib, id_ = _inv2x2_sym(ha, hb, hd)

    # Hpl_f components (p, a): hpl[p][a] = wr p0p l0a + wb p1p l1a
    hpl00 = -h00
    hpl01 = -h01
    hpl10 = hpl01
    hpl11 = -h11
    hpl20 = -wb * l10
    hpl21 = -wb * l11

    # per-factor Hpl Hll^-1 (linear, so summing per landmark commutes)
    lm = obs_lm.long()
    ia_f, ib_f, id_f = ia[lm], ib[lm], id_[lm]
    ghl00 = hpl00 * ia_f + hpl01 * ib_f
    ghl01 = hpl00 * ib_f + hpl01 * id_f
    ghl10 = hpl10 * ia_f + hpl11 * ib_f
    ghl11 = hpl10 * ib_f + hpl11 * id_f
    ghl20 = hpl20 * ia_f + hpl21 * ib_f
    ghl21 = hpl20 * ib_f + hpl21 * id_f
    bl0_f, bl1_f = bl0[lm], bl1[lm]

    kf_sums = segment_sum(torch.stack([
        h00, h01, h02, h11, h12, h22,
        -bl_f0, -bl_f1, -wb1,
        ghl00 * bl0_f + ghl01 * bl1_f,
        ghl10 * bl0_f + ghl11 * bl1_f,
        ghl20 * bl0_f + ghl21 * bl1_f,
    ]), layout.by_kf)                     # float64, as the reduced system
    hpp_diag = _assemble_sym3(*kf_sums[:6])
    bp_obs = kf_sums[6:9].T
    rs_corr = kf_sums[9:12].T
    if marks is not None:
        marks("schur")

    # cross via the ordered factor-pair list: 9 planes summed by cell
    pv = pair_valid.to(r0.dtype)
    pa, pb = pair_a.long(), pair_b.long()
    ghl = ((ghl00, ghl01), (ghl10, ghl11), (ghl20, ghl21))
    hpl = ((hpl00, hpl01), (hpl10, hpl11), (hpl20, hpl21))
    planes = []
    for p in range(3):
        gp0 = ghl[p][0][pa]
        gp1 = ghl[p][1][pa]
        for qq in range(3):
            planes.append(pv * (gp0 * hpl[qq][0][pb] + gp1 * hpl[qq][1][pb]))
    cross = segment_sum(torch.stack(planes), layout.by_cell)
    cross = cross.reshape(3, 3, k, k).permute(2, 3, 0, 1)
    if marks is not None:
        marks("cross")
    return (hpp_diag, bp_obs, cross, rs_corr, (ia, ib, id_), (bl0, bl1),
            (hpl00, hpl01, hpl10, hpl11, hpl20, hpl21))


def backsubstitute_landmarks_sparse(dp, hll_inv_c, bl_c, hpl_c, obs_kf, obs_lm, l: int,
                                    by_lm: Optional[Segments] = None):
    """dl = Hll^-1 (bl - Hpl' dp) with the Hpl' dp contraction as one
    segment sum of two columns by landmark (``by_lm``; every factor when
    none is given: an invalid factor's Hpl is zero).  Returns
    ``(dlx [L], dly [L])``."""
    ia, ib, id_ = hll_inv_c
    bl0, bl1 = bl_c
    hpl00, hpl01, hpl10, hpl11, hpl20, hpl21 = hpl_c
    if by_lm is None:
        by_lm = segment_layout(obs_lm, None, l)
    kf = obs_kf.long()
    dp0 = dp[:, 0][kf]
    dp1 = dp[:, 1][kf]
    dp2 = dp[:, 2][kf]
    t0 = hpl00 * dp0 + hpl10 * dp1 + hpl20 * dp2
    t1 = hpl01 * dp0 + hpl11 * dp1 + hpl21 * dp2
    sums = segment_sum(torch.stack([t0, t1]), by_lm).to(t0.dtype)
    u0 = bl0 - sums[0]
    u1 = bl1 - sums[1]
    return ia * u0 + ib * u1, ib * u0 + id_ * u1


def reduced_system(big_h, bp, hpp_diag, bp_obs, cross, rs_corr):
    """``S [3K, 3K]`` and ``rs [3K]``, float64, from the pose system and the
    (summed) landmark terms."""
    k = big_h.shape[0]
    idx = torch.arange(k, device=big_h.device)
    big_h = big_h.double()
    big_h[idx, idx] = big_h[idx, idx] + hpp_diag.double()
    big_h = big_h - cross.double()
    rs = bp.double() + bp_obs.double() - rs_corr.double()
    return big_h.permute(0, 2, 1, 3).reshape(3 * k, 3 * k), rs.reshape(3 * k)


def solve_pos(s_mat, rs):
    """``jax.scipy.linalg.solve(s_mat, rs, assume_a="pos")``: a Cholesky
    factor of the upper triangle, then two triangular solves.  Where the
    matrix is not positive definite the step is NaN (``info`` checked on the
    device, no host sync)."""
    chol, info = torch.linalg.cholesky_ex(s_mat.mT)
    x = torch.cholesky_solve(rs[:, None], chol)[:, 0]
    return torch.where(info == 0, x, torch.nan)


def schur_normal_equations(poses, landmarks, g: PoseGraph, damping,
                           layout: Optional[Layouts] = None):
    """Full reduced pose system: pose part + landmark part combined.

    Returns (S [3K, 3K], rs [3K], hll_inv [L, 2, 2], bl [L, 2],
    hpl_dense [K, L, 3, 2]).
    """
    big_h, bp = pose_system(poses, g, damping)
    hpp_diag, bp_obs, cross, rs_corr, hll_inv, bl, hpl_dense = landmark_system(
        poses, landmarks, g, damping, layout)
    s_mat, rs = reduced_system(big_h, bp, hpp_diag, bp_obs, cross, rs_corr)
    return s_mat, rs, hll_inv, bl, hpl_dense


def backsubstitute_landmarks(dp, hll_inv, bl, hpl_dense):
    """dl = Hll^-1 (bl - Hpl' dp) — shard-local under map-axis sharding."""
    u = bl - torch.einsum("klpb,kp->lb", hpl_dense, dp)
    return hll_inv[:, :, 0] * u[:, 0, None] + hll_inv[:, :, 1] * u[:, 1, None]


def apply_pose_step(poses, dp):
    """``poses + dp`` with the heading wrapped."""
    new = poses + dp
    return torch.cat([new[:, :2], wrap_angle(new[:, 2:])], dim=1)


def gauss_newton_step(poses, landmarks, g: PoseGraph, damping,
                      layout: Optional[Layouts] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped GN step; returns updated (poses, landmarks)."""
    k = poses.shape[0]
    s_mat, rs, hll_inv, bl, hpl_dense = schur_normal_equations(
        poses, landmarks, g, damping, layout)
    dp = solve_pos(s_mat, rs).to(poses.dtype).reshape(k, 3)
    dl = backsubstitute_landmarks(dp, hll_inv, bl, hpl_dense)
    return apply_pose_step(poses, dp), landmarks + dl


def total_error(poses, landmarks, g: PoseGraph) -> torch.Tensor:
    r_odo, _ = _odo_residuals(poses, g)
    r_obs, _ = _obs_residuals(poses, landmarks, g)
    w_odo = torch.where(g.odo_valid[:, None], g.odo_info, 0.0)
    w_obs = torch.where(g.obs_valid[:, None], g.obs_info, 0.0)
    return torch.sum(r_odo * r_odo * w_odo) + torch.sum(r_obs * r_obs * w_obs)


def optimize(g: PoseGraph, num_iters: int = 10, damping: float = 1e-6):
    """Levenberg-Marquardt loop of ``num_iters`` iterations on the device.

    Accept/reject with adaptive damping: lambda /= 2 on improvement,
    lambda *= 10 on regression (step rejected).  A NaN step (a failed
    Cholesky at low damping) compares as no improvement, so it is rejected
    and the current iterate kept.  Returns ``(poses, landmarks, err,
    history [num_iters])``, all on the graph's device.
    """
    layout = dense_layout(g)
    poses, landmarks = g.poses, g.landmarks
    err = total_error(poses, landmarks, g)
    lam = torch.tensor(damping, dtype=poses.dtype, device=poses.device)
    hist = []
    for _ in range(num_iters):
        new_p, new_l = gauss_newton_step(poses, landmarks, g, lam, layout)
        new_err = total_error(new_p, new_l, g)
        improved = new_err < err
        poses = torch.where(improved, new_p, poses)
        landmarks = torch.where(improved, new_l, landmarks)
        lam = torch.where(improved, lam * 0.5, lam * 10.0)
        err = torch.where(improved, new_err, err)
        hist.append(err)
    history = torch.stack(hist) if hist else err.new_zeros(0)
    return poses, landmarks, err, history
