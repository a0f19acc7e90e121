"""Co-visibility consensus alignment: remove accumulated trajectory drift
BEFORE landmark association, using only the observations themselves.

A numpy copy of ``fastslam_tpu/backend/alignment.py`` (which imports no
JAX); the port keeps its own.  Its outputs equal the reference's exactly.
One difference: :func:`_pairs_within` warns, naming how many candidate
pairs it cut, whenever its per-point cap binds (the reference truncates
without a word); the pairs it returns are the same.

Why this exists (the failure it fixes): world-frame clustering associates two
observations of the same corner when their projections from the *drifted*
input trajectory fall within a fixed gate.  Relative drift between two
keyframes grows like sigma_xy*sqrt(dt) (plus heading drift times range), so
once it approaches half the landmark separation NO fixed gate works: tight
gates split every temporally-distant same-landmark pair (deleting exactly the
loop closures the backend needs), loose gates merge distinct landmarks.

The way out is a classic SLAM observation: every landmark co-observed by the
same keyframe *pair* (a, b) is displaced by the SAME rigid offset (the
relative pose error between a and b), while projections of *different*
landmarks displace essentially at random.  That shared offset is therefore
estimable by consensus long before any individual association is safe:

1.  For each spatially-overlapping, temporally-separated keyframe pair,
    register the two sets of world-projected observations — a coarse 2-D
    displacement-histogram mode (immune to the ~N^2 false pairs: true pairs
    all vote for one bin) followed by small-angle Procrustes refinement
    rounds (nearest-neighbor matches -> closed-form (t, omega) -> tighter
    gate).
2.  Solve one small linear least-squares over per-keyframe drift states
    e_k = (ex, ey, etheta): a random-walk prior (the drift model), an anchor
    on keyframe 0, and for every registered pair the linearized constraint

        etheta_b - etheta_a                                     = omega_ab
        (exy_b + etheta_b*J(c-x_b)) - (exy_a + etheta_a*J(c-x_a)) = t_ab

    where c is the matched-point centroid, J the 90-degree rotation, and the
    coefficients follow from the first-order projection error
    p_k(l) - l = exy_k + etheta_k * J(l - x_k).  Pair weights come from the
    registration residual; an IRLS round downweights outlier registrations.
3.  Subtract the solved drift from the input trajectory.  Association then
    runs at the corrected poses with a *tight* gate.

Everything here is host-side NumPy, like the rest of the builder: graph
construction is a one-off per optimization window, not a hot path.  No
ground truth is used anywhere.
"""

from __future__ import annotations

import warnings
from typing import List, Sequence, Tuple

import numpy as np


def _world_project(kf: np.ndarray, obs_kf: np.ndarray,
                   obs_rb: np.ndarray) -> np.ndarray:
    """World-frame (x, y) of each observation from its keyframe pose, [F, 2]."""
    th = kf[obs_kf, 2] + obs_rb[:, 1]
    return np.stack([kf[obs_kf, 0] + obs_rb[:, 0] * np.cos(th),
                     kf[obs_kf, 1] + obs_rb[:, 0] * np.sin(th)], axis=-1)


def _grid_runs(pts: np.ndarray, cell: float):
    """Bucket points into ``cell``-sized grid cells.

    Returns (sorted point order, sorted cell keys, unique keys, run starts,
    run ends) so callers can look up all points in a cell via searchsorted.
    """
    c = np.floor(pts / cell).astype(np.int64)
    key = (c[:, 0] << 32) ^ (c[:, 1] & 0xFFFFFFFF)
    order = np.argsort(key, kind="stable")
    skey = key[order]
    uniq, starts = np.unique(skey, return_index=True)
    ends = np.concatenate([starts[1:], [len(skey)]])
    return order, uniq, starts, ends


def _pairs_within(qa: np.ndarray, qb: np.ndarray, radius: float,
                  max_pairs_per_a: int = 64):
    """All index pairs (i into qa, j into qb) with |qb_j - qa_i| < radius.

    Grid-bucket sweep over the 3x3 neighborhood — O(n) for bounded local
    density, never materializes an [Na, Nb] matrix.  At most
    ``max_pairs_per_a`` candidates of one grid cell are examined per point
    of ``qa``; when that cap cuts candidates, a warning names how many.
    """
    if len(qa) == 0 or len(qb) == 0:
        return (np.zeros(0, np.int64),) * 2
    order, uniq, starts, ends = _grid_runs(qb, radius)
    ca = np.floor(qa / radius).astype(np.int64)
    ii: List[np.ndarray] = []
    jj: List[np.ndarray] = []
    cut = 0
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            nk = ((ca[:, 0] + ox) << 32) ^ ((ca[:, 1] + oy) & 0xFFFFFFFF)
            pos = np.searchsorted(uniq, nk)
            pos_c = np.minimum(pos, len(uniq) - 1)
            hit = uniq[pos_c] == nk
            if not hit.any():
                continue
            a_idx = np.flatnonzero(hit)
            s = starts[pos_c[a_idx]]
            e = ends[pos_c[a_idx]]
            n = np.minimum(e - s, max_pairs_per_a)
            cut += int((e - s - n).sum())
            total = int(n.sum())
            if total == 0:
                continue
            rep_a = np.repeat(a_idx, n)
            offs = np.arange(total) - np.repeat(np.cumsum(n) - n, n)
            rep_b = order[np.repeat(s, n) + offs]
            d2 = ((qb[rep_b] - qa[rep_a]) ** 2).sum(-1)
            keep = d2 < radius * radius
            ii.append(rep_a[keep])
            jj.append(rep_b[keep])
    if cut:
        warnings.warn(
            f"_pairs_within: the cap of {max_pairs_per_a} candidates per point and "
            f"grid cell cut {cut} candidate pairs (radius {radius}); pairs among them "
            "are missing from the result",
            stacklevel=2,
        )
    if not ii:
        return (np.zeros(0, np.int64),) * 2
    return np.concatenate(ii), np.concatenate(jj)


def register_clouds(
    wa: np.ndarray,
    wb: np.ndarray,
    *,
    window: float = 5.0,
    coarse_bin: float = 1.0,
    refine_gates: Sequence[float] = (1.0, 0.45, 0.3),
    min_matches: int = 30,
    omega_candidates: Sequence[float] = (0.0,),
    axis: np.ndarray | None = None,
    window_perp: float | None = None,
    coarse_points: int = 1400,
):
    """Estimate the rigid offset carrying cloud ``wa`` onto cloud ``wb``.

    Model: wb_match ~= wa_match + t + omega * J(wa_match - c).  Returns
    ``(t [2], omega, c [2], n_matches, rms, spread2)`` or ``None`` when no
    consensus is found (too few matches).

    Stage 1 — displacement-histogram mode: every cross-cloud point pair
    within the search box votes its displacement into ``coarse_bin``-sized
    bins; same-landmark pairs all vote for (approximately) one bin, false
    pairs scatter over the box, so the mode is the consensus translation
    even when same-landmark pairs are a small minority.  Two prior-driven
    refinements for trajectory use:

    * ``omega_candidates``: when a non-trivial relative rotation is
      plausible (long-range clouds: 5 mrad over 100 m smears the true peak
      across bins while a structured world's self-similar false peak stays
      sharp), each candidate de-rotates the displacements about the cloud
      centroid before binning and the best (candidate, bin) count wins.
    * anisotropic window: the *common* absolute heading error of the two
      keyframes times their baseline displaces cloud a vs cloud b
      PERPENDICULAR to the baseline (t ~= e_b - e_a + domega*J(c - x_b)
      + etheta_a*J(x_a - x_b)); pass the unit baseline direction as
      ``axis`` and a larger ``window_perp`` so late-trajectory pairs (where
      that term reaches several meters) keep their true peak inside the
      searched box without opening the full area to false peaks.

    When the box is large the coarse stage subsamples each cloud to
    ``coarse_points`` points — vote counts scale down together, the mode is
    unchanged, and the pair enumeration stays O(points * box density).

    Stage 2 — Procrustes refinement: nearest-neighbor matches within a
    shrinking gate around the current estimate; closed-form small-angle
    (t, omega) least squares per round — always on the FULL clouds.
    """
    if axis is None:
        ax = np.array([1.0, 0.0])
    else:
        ax = np.asarray(axis, np.float64)
        ax = ax / max(np.linalg.norm(ax), 1e-12)
    perp = np.array([-ax[1], ax[0]])
    w_par = float(window)
    w_per = float(window if window_perp is None else window_perp)

    c0 = wa.mean(axis=0)
    sa = wa[:: max(1, int(np.ceil(len(wa) / coarse_points)))]
    sb = wb[:: max(1, int(np.ceil(len(wb) / coarse_points)))]
    # margin so pairs displaced by the largest candidate rotation still land
    # inside the search window
    om_max = max(abs(float(o)) for o in omega_candidates)
    arm = np.sqrt(((wa - c0) ** 2).sum(-1).max()) if len(wa) else 0.0
    ii, jj = _pairs_within(sa, sb, max(w_par, w_per) + om_max * arm,
                           max_pairs_per_a=512)
    if len(ii) < min_matches:
        return None
    d_raw = sb[jj] - sa[ii]
    jrel_a = np.stack([-(sa[ii] - c0)[:, 1], (sa[ii] - c0)[:, 0]], -1)
    best = None
    for om_c in omega_candidates:
        d = d_raw - om_c * jrel_a
        d_par = d @ ax
        d_per = d @ perp
        inside = (np.abs(d_par) < w_par) & (np.abs(d_per) < w_per)
        if inside.sum() < min_matches:
            continue
        dc = np.stack([d_par[inside], d_per[inside]], -1)
        bins = np.floor(dc / coarse_bin).astype(np.int64)
        key = (bins[:, 0] << 32) ^ (bins[:, 1] & 0xFFFFFFFF)
        uniq, counts = np.unique(key, return_counts=True)
        hit = int(np.argmax(counts))
        if best is None or counts[hit] > best[0]:
            best = (int(counts[hit]), float(om_c), uniq[hit], dc)
    if best is None:
        return None
    _, omega, mode_key, d = best
    mode_bin = np.array([mode_key >> 32, mode_key << 32 >> 32],
                        np.float64)
    t_rot = (mode_bin + 0.5) * coarse_bin
    # average over the 3x3 bin neighborhood of the mode for a better start
    near = (np.abs(d - t_rot) < 1.5 * coarse_bin).all(axis=1)
    if near.sum() >= max(8, min_matches // 4):
        t_rot = d[near].mean(axis=0)
    t = t_rot[0] * ax + t_rot[1] * perp

    c = c0
    rms = np.inf
    spread2 = 1.0
    for gate in refine_gates:
        # predicted positions of wa points in wb's frame under (t, omega, c)
        rel = wa - c
        pred = wa + t + omega * np.stack([-rel[:, 1], rel[:, 0]], -1)
        pi, pj = _pairs_within(pred, wb, gate)
        if len(pi) < min_matches:
            return None
        # keep only the nearest wb point per wa point (unique matches)
        d2 = ((wb[pj] - pred[pi]) ** 2).sum(-1)
        order = np.lexsort((d2, pi))
        first = np.concatenate([[True], pi[order][1:] != pi[order][:-1]])
        mi, mj = pi[order][first], pj[order][first]

        u = wa[mi]
        delta = wb[mj] - u
        c = u.mean(axis=0)
        rel = u - c
        jrel = np.stack([-rel[:, 1], rel[:, 0]], -1)
        dbar = delta.mean(axis=0)
        dd = delta - dbar
        spread2 = (rel * rel).sum(-1).mean()
        denom = max(spread2 * len(u), 1e-9)
        omega = float((dd * jrel).sum() / denom)
        t = dbar
        resid = delta - t - omega * jrel
        rms = float(np.sqrt((resid * resid).sum(-1).mean()))
        n = len(u)
    return t, float(omega), c, int(n), rms, float(spread2)


def candidate_pairs(
    kf: np.ndarray,
    *,
    radius: float,
    min_dt: int = 2,
) -> np.ndarray:
    """Keyframe pairs (i < j) that plausibly co-observe landmarks: within
    ``radius`` of each other spatially and at least ``min_dt`` apart in time
    (consecutive keyframes are already tied by the odometry prior)."""
    xy = kf[:, :2]
    k = len(kf)
    if k <= 4096:
        # at the documented keyframe counts (~1e3) the [K, K] distance
        # matrix is tiny
        d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
        i, j = np.nonzero(d2 < radius * radius)
    else:
        # longer trajectories: the dense matrix is O(K^2) memory — reuse
        # the grid-bucket sweep (O(K) for bounded spatial density)
        i, j = _pairs_within(xy, xy, radius, max_pairs_per_a=1 << 16)
    keep = (j - i) >= min_dt
    return np.stack([i[keep], j[keep]], axis=-1)


def consensus_align(
    keyframe_poses: np.ndarray,
    measurements: Sequence[np.ndarray],
    *,
    sigma_xy: float = 0.05,
    sigma_theta: float = 0.001,
    pair_radius: float | None = None,
    pair_min_dt: int = 2,
    window: float = 5.0,
    refine_gates: Sequence[float] = (1.0, 0.45, 0.3),
    min_matches: int = 30,
    max_pair_rms: float = 0.5,
    irls_rounds: int = 2,
    session_boundaries: Sequence[int] = (),
    cross_session_t_sd: float = 0.5,
    cross_session_om_sd: float = 0.02,
) -> Tuple[np.ndarray, dict]:
    """Estimate and subtract per-keyframe drift (see module doc).

    Args:
      keyframe_poses: ``[K, 3]`` drifted trajectory estimate.
      measurements: length-K list of ``[m_k, 2]`` (range, bearing) arrays —
        the same structure ``build_pose_graph`` takes.
      sigma_xy / sigma_theta: per-step random-walk scale of the drift prior.
      pair_radius: spatial radius for candidate keyframe pairs; default
        2.2x the 95th-percentile observation range.
      window / refine_gates / min_matches: registration knobs
        (:func:`register_clouds`).
      max_pair_rms: registrations with worse residual RMS are discarded.
      irls_rounds: reweighting rounds that suppress outlier registrations.
      session_boundaries: keyframe indices where a NEW session starts
        (multi-session joint alignment, the same convention as
        ``build_pose_graph``): the random-walk prior is cut across each
        boundary (no odometry links independent trajectories), and pairs
        SPANNING a boundary use the cross-session prior below instead of
        the within-session random-walk model — those pairs are precisely
        the cross-session loop closures.
      cross_session_t_sd / cross_session_om_sd: translation / rotation
        scale of the relative error between independently-drifted (and
        pre-aligned, e.g. map_merge) sessions.

    Returns ``(corrected_poses [K, 3], info)`` where ``info`` records the
    pair count, inlier count, and the solved drift field.
    """
    kf = np.asarray(keyframe_poses, np.float64)
    k = kf.shape[0]
    counts = [np.asarray(m, np.float64).reshape(-1, 2).shape[0]
              for m in measurements]
    obs_kf = np.repeat(np.arange(k, dtype=np.int64), counts)
    obs_rb = (np.concatenate(
        [np.asarray(m, np.float64).reshape(-1, 2) for m in measurements]
    ) if sum(counts) else np.zeros((0, 2)))
    w = _world_project(kf, obs_kf, obs_rb)

    if pair_radius is None:
        r95 = float(np.percentile(obs_rb[:, 0], 95)) if len(obs_rb) else 10.0
        pair_radius = 2.2 * r95
    pairs = candidate_pairs(kf, radius=pair_radius, min_dt=pair_min_dt)

    # per-keyframe observation slices (obs_kf is sorted by construction)
    starts = np.searchsorted(obs_kf, np.arange(k))
    ends = np.searchsorted(obs_kf, np.arange(k) + 1)

    regs = []   # (a, b, t, omega, c, n, rms, spread2)
    for a, b in pairs:
        wa = w[starts[a]: ends[a]]
        wb = w[starts[b]: ends[b]]
        # prior-driven search ranges.  The pair offset decomposes as
        #   t = (e_b - e_a) + domega*J(c - x_b) + etheta_a*J(x_a - x_b):
        # a relative random walk (small, isotropic) plus the COMMON absolute
        # heading error times the baseline — perpendicular to the baseline
        # and growing with sqrt(min(a, b)); the search box is therefore
        # anisotropic, and omega candidates are scanned fine enough that
        # residual rotation smear stays under a histogram bin at this
        # pair's range scale
        dt = float(b - a)
        base_vec = kf[b, :2] - kf[a, :2]
        baseline = float(np.linalg.norm(base_vec))
        arm = max(0.75 * baseline, 1.0)
        spans_boundary = any(a < s <= b for s in session_boundaries)
        if spans_boundary:
            # independent trajectories: relative error is the two sessions'
            # combined absolute drift / pre-alignment residual, not a
            # shared random walk
            sd_rel = cross_session_t_sd
            sd_common = cross_session_t_sd
            om_sd = cross_session_om_sd
        else:
            sd_rel = np.sqrt(dt * 2.0 * sigma_xy ** 2
                             + dt * sigma_theta ** 2 * arm ** 2)
            sd_common = np.sqrt(float(min(a, b))) * sigma_theta * baseline
            om_sd = np.sqrt(dt) * sigma_theta
        w_par = float(np.clip(6.0 * sd_rel + 1.0, 2.0, window))
        w_per = float(np.clip(
            6.0 * np.sqrt(sd_rel ** 2 + sd_common ** 2) + 1.0, 2.0,
            max(window, 6.0 * sd_common + 2.0)))
        om_step = max(0.5 / arm, om_sd / 6.0)
        n_side = min(12, int(np.ceil(4.0 * om_sd / om_step)))
        om_cands = om_step * np.arange(-n_side, n_side + 1)
        r = register_clouds(wa, wb, window=w_par, window_perp=w_per,
                            axis=base_vec,
                            refine_gates=refine_gates,
                            min_matches=min_matches,
                            omega_candidates=om_cands)
        if r is None:
            continue
        t, omega, c, n, rms, spread2 = r
        if rms > max_pair_rms:
            continue
        # drift-prior plausibility: an offset many sigma outside the model
        # above is a false registration (e.g. a lattice-aliased peak on a
        # structured world), not drift
        axu = base_vec / max(baseline, 1e-12)
        t_par = float(t @ axu)
        t_per = float(t @ np.array([-axu[1], axu[0]]))
        if (abs(t_par) > 6.0 * sd_rel + 0.05
                or abs(t_per) > 6.0 * np.sqrt(sd_rel ** 2 + sd_common ** 2)
                + 0.05
                or abs(omega) > 6.0 * om_sd + 1e-4):
            continue
        regs.append((int(a), int(b), t, omega, c, n, rms, spread2))

    # cohort-relative quality gate: on worlds with repetitive structure a
    # barely-overlapping pair can register onto a self-similar false
    # alignment of NON-shared landmarks — recognizable against the cohort by
    # an order-of-magnitude smaller match count and a worse residual (the
    # false alignment matches distinct landmarks, so its rms is the
    # structure's jitter scale, not the observation noise).  Healthy pairs
    # dominate the medians, so gate relative to them.
    if len(regs) >= 8:
        med_n = float(np.median([r[5] for r in regs]))
        med_rms = float(np.median([r[6] for r in regs]))
        regs = [r for r in regs
                if r[5] >= 0.25 * med_n and r[6] <= 1.5 * med_rms + 1e-3]

    info = {"n_candidate_pairs": int(len(pairs)),
            "n_registered_pairs": len(regs)}
    if not regs:
        info["drift"] = np.zeros((k, 3))
        return kf.copy(), info

    # ---- linear least squares over e = [ex, ey, etheta] per keyframe ----
    def solve(weight_scale: np.ndarray):
        h = np.zeros((3 * k, 3 * k))
        rhs = np.zeros(3 * k)

        # anchor e_0 = 0
        h[0:3, 0:3] += np.eye(3) * 1e6

        # random-walk prior e_{i+1} - e_i = 0 (cut across session
        # boundaries: independent trajectories share no odometry link —
        # each later session is instead anchored softly so its gauge stays
        # solvable even with no cross-session pair)
        wprior = np.array([1.0 / sigma_xy ** 2, 1.0 / sigma_xy ** 2,
                           1.0 / sigma_theta ** 2])
        # per-component anchor: x/y at the cross-session translation
        # scale, theta at the cross-session rotation scale — a shared
        # 1/t_sd^2 weight would leave a later session's rotation gauge
        # ~600x looser than the stated om_sd model when no cross-session
        # pair registers
        wanchor = np.array([1.0 / max(cross_session_t_sd ** 2, 1e-12),
                            1.0 / max(cross_session_t_sd ** 2, 1e-12),
                            1.0 / max(cross_session_om_sd ** 2, 1e-12)])
        for s in session_boundaries:
            if 0 < s < k:
                i0 = 3 * s
                h[i0:i0 + 3, i0:i0 + 3] += np.diag(wanchor)
        for i in range(k - 1):
            if (i + 1) in session_boundaries:
                continue
            a0, b0 = 3 * i, 3 * (i + 1)
            for d in range(3):
                h[a0 + d, a0 + d] += wprior[d]
                h[b0 + d, b0 + d] += wprior[d]
                h[a0 + d, b0 + d] -= wprior[d]
                h[b0 + d, a0 + d] -= wprior[d]

        for ridx, (a, b, t, omega, c, n, rms, spread2) in enumerate(regs):
            var = max(rms * rms, 1e-4) / max(n, 1)
            wt = weight_scale[ridx] / var
            wom = weight_scale[ridx] * max(spread2, 1e-6) / var
            # omega constraint: etheta_b - etheta_a = omega
            ja = np.zeros(3 * k)
            ja[3 * b + 2] = 1.0
            ja[3 * a + 2] = -1.0
            idx = [3 * a + 2, 3 * b + 2]
            jrow = np.array([-1.0, 1.0])
            h[np.ix_(idx, idx)] += wom * np.outer(jrow, jrow)
            rhs[idx] += wom * jrow * omega
            # translation constraint (2 eqs):
            # (exy_b + etheta_b J(c - x_b)) - (exy_a + etheta_a J(c - x_a)) = t
            jca = c - kf[a, :2]
            jcb = c - kf[b, :2]
            for d, tcomp in enumerate(t):
                cols = np.array([3 * a + d, 3 * b + d,
                                 3 * a + 2, 3 * b + 2])
                jrot_a = -jca[1] if d == 0 else jca[0]
                jrot_b = -jcb[1] if d == 0 else jcb[0]
                vals = np.array([-1.0, 1.0, -jrot_a, jrot_b])
                h[np.ix_(cols, cols)] += wt * np.outer(vals, vals)
                rhs[cols] += wt * vals * tcomp
        e = np.linalg.solve(h, rhs)
        return e.reshape(k, 3)

    scale = np.ones(len(regs))
    e = solve(scale)
    for _ in range(irls_rounds):
        # Huber-style downweight of registrations inconsistent with the field
        resid = []
        for (a, b, t, omega, c, n, rms, spread2) in regs:
            jca = c - kf[a, :2]
            jcb = c - kf[b, :2]
            pred_t = (e[b, :2] + e[b, 2] * np.array([-jcb[1], jcb[0]])
                      - e[a, :2] - e[a, 2] * np.array([-jca[1], jca[0]]))
            resid.append(float(np.linalg.norm(pred_t - t)))
        resid = np.asarray(resid)
        mad = np.median(resid) + 1e-6
        scale = np.minimum(1.0, (3.0 * mad / np.maximum(resid, 1e-12)) ** 2)
        e = solve(scale)

    corrected = kf.copy()
    corrected[:, :2] -= e[:, :2]
    corrected[:, 2] -= e[:, 2]
    corrected[:, 2] = (corrected[:, 2] + np.pi) % (2 * np.pi) - np.pi
    info["drift"] = e
    info["n_inlier_pairs"] = int((scale > 0.5).sum())
    return corrected, info
