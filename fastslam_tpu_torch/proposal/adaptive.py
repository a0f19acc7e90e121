"""Online odometry-error estimation for the FastSLAM 2.0 proposal.

A numpy-only copy of ``fastslam_tpu/proposal/adaptive.py``, kept in this
package so that it imports nothing of the JAX package; the batched replay
(``app/runner.py:icp_floor_stage``) and the online loop
(``SLAMRunner.icp_refine``) share it.

The fs2 proposal needs per-tick noise floors matched to the REAL odometry
error (config.py: floors far from the true error hurt either way — tight
floors win on clean logs, wide floors win under wheel slip), and the
command-vs-ICP odometry blend needs the same error split.  The only online
signal is the ICP-vs-command residual, which mixes three things the
estimator must separate:

* the command odometry's error (wheel slip) — what the floors/blend want,
* the scan matcher's white noise (~1 mm / ~2.5 mrad per tick here),
* the scan matcher's systematic BIAS (measured: a stable +4.3 mrad/tick
  rotation bias on the standard drive, mean ~= median, LARGER than the
  matcher's noise — pure-ICP dead reckoning drifts 0.18 m in 150 ticks).

Separation tools (greenfield; the reference never estimates its noise —
config.py:11-12 hard-codes it):

* ``se2_residuals``: full SE(2) ICP-vs-command residual per tick.  The
  match estimates BOTH components every tick, so both moments see ~every
  tick (active-component-only gating starves the theta moment for the
  first ~87 ticks of the standard drive — its entire first turn).
* ``consistency_discrepancy``: direct two-step match scan(t-2)->scan(t) vs
  the composition of the two single-step matches.  The true motion AND any
  slowly-varying match bias cancel, so the discrepancy samples the
  matcher's WHITE noise: ``var(direct - composed) = 3 sigma_icp^2``.
* bias: the trailing MEDIAN of the signed residual.  Slip is zero-mean, so
  the median estimates the matcher bias through slip as well as clean.
* ``floor_schedule``: median-window moments (ICP failures are heavy-tailed
  — measured trans-residual sd 9.6 mm vs median-based sigma 1.2 mm — and
  one aliased wall match must not whip an annealed floor open), quadrature
  subtraction on the DEBIASED residual, an MMSE blend of commands with the
  DEBIASED match, and floors that track the error of the blended odometry
  the filter actually receives.

All statistics are per tick type (rotation vs translation tick): the
reference's rotation-XOR-translation odometry makes the two genuinely
different regimes (slip hits only the active component; the matcher is
noisier while rotating), and the kernels take per-tick floors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FloorSchedule(NamedTuple):
    floors_xy: np.ndarray   # [T] per-tick xy proposal floor
    floors_th: np.ndarray   # [T] per-tick theta proposal floor
    blend_xy: np.ndarray    # [T] command-vs-ICP blend for translation
    blend_th: np.ndarray    # [T] command-vs-ICP blend for rotation
    bias_tr: np.ndarray     # [T] ICP along-track bias estimate (subtract
    #                         from icp_trs before blending)
    bias_th: np.ndarray     # [T] ICP rotation bias estimate (subtract
    #                         from icp_rots before blending)
    dial: np.ndarray        # [T] fs2 proposal mode dial in [0, 1]
    #                         (kernels.fastslam2_propose evidence_scale)
    lat_gate: np.ndarray    # [T] per-tick match-failure gate: blend only
    #                         when |lateral residual| < lat_gate
    diag: dict              # moment traces for tests / debugging


def se2_residuals(angs, tvecs, rots, trans):
    """Per-tick signed ICP-vs-command residuals, XOR-convention aligned.

    ``angs``/``tvecs`` are the composite single-step match estimates for
    ticks 1..T-1 (angle, translation of the map frame(t-1)->frame(t)); the
    command predicts angle ``-rot`` and translation ``(-tr, 0)``.

    Returns ``(sr_th [T], sr_al [T], lat [T])`` with tick 0 zeroed:
    ``sr_th`` is the rotation residual (equals ``icp_rot - rot`` on
    rotation ticks), ``sr_al`` the signed along-track translation residual
    (~ ``icp_tr - trans`` on translation ticks), ``lat`` the lateral
    translation residual."""
    t_total = len(rots)
    sr_th = np.zeros(t_total, np.float32)
    sr_al = np.zeros(t_total, np.float32)
    lat = np.zeros(t_total, np.float32)
    av = np.asarray(angs)
    tv = np.asarray(tvecs)
    sr_th[1:] = ((-av - rots[1:]) + np.pi) % (2 * np.pi) - np.pi
    sr_al[1:] = -(tv[:, 0] + trans[1:])
    lat[1:] = tv[:, 1]
    return sr_th, sr_al, lat


def consistency_discrepancy(angs, tvecs, dir_ang, dir_t):
    """Direct-vs-composed two-step discrepancy (pure ICP white noise).

    ``dir_ang``/``dir_t`` are the direct scan(t-2)->scan(t) estimates for
    ticks 2..T-1.  Returns ``(d_ang [T-2], d_t2 [T-2])`` where ``d_t2`` is
    the summed-2-axis squared translation discrepancy."""
    a1, t1 = np.asarray(angs)[:-1], np.asarray(tvecs)[:-1]
    a2, t2 = np.asarray(angs)[1:], np.asarray(tvecs)[1:]
    c_ang = a1 + a2
    c2, s2 = np.cos(a2), np.sin(a2)
    c_t = np.stack([c2 * t1[:, 0] - s2 * t1[:, 1],
                    s2 * t1[:, 0] + c2 * t1[:, 1]], -1) + t2
    da = np.asarray(dir_ang) - c_ang
    d_ang = (da + np.pi) % (2 * np.pi) - np.pi
    d_t2 = ((np.asarray(dir_t) - c_t) ** 2).sum(-1)
    return d_ang, d_t2


# median of chi^2_1 — scales a median of squared Gaussian samples to the
# variance
_CHI2_MED = 0.4549364231195736
# half the median of chi^2_2 (= ln 2 * 2 / 2): the qw_xy window holds
# (sigma^2/2) * chi2_2 samples (d_t2 sums the SQUARED discrepancy over both
# axes, each ~ N(0, 3 sigma^2), pushed as d_t2/6), so the per-axis variance
# is median / (chi2_2_med / 2).  Scaling by the chi2_1 median instead
# overestimates sigma^2 by 1.52x.
_CHI2_2_MED_HALF = float(np.log(2.0))


def _var(window: list) -> float:
    """Robust variance estimate from a window of squared samples."""
    if not window:
        return 0.0
    return float(np.median(window)) / _CHI2_MED


def _var2(window: list) -> float:
    """Per-axis variance from a window of (sigma^2/2)*chi2_2 samples."""
    if not window:
        return 0.0
    return float(np.median(window)) / _CHI2_2_MED_HALF


class _TypedWindows:
    """Trailing per-tick-type windows with cross-type fallback."""

    def __init__(self, win):
        self.win = win
        self.w = {0: [], 1: []}

    def push(self, k, v):
        w = self.w[k]
        w.append(float(v))
        if len(w) > self.win:
            w.pop(0)

    def get(self, k):
        return self.w[k] if self.w[k] else self.w[1 - k]


class OnlineFloorEstimator:
    """Incremental form of :func:`floor_schedule` — ``push`` residuals as
    they arrive, ``read`` the outputs for the NEXT tick's type.

    The batched replay and the online per-tick engines share this single
    implementation AND the same read-before-push ordering (every path's
    tick-t outputs use residuals from ticks < t only), so the production
    paths cannot drift apart — EVAL numbers from the batched adaptive rows
    are reproducible by the online engine (an earlier push-then-read
    batched path saw tick t's own residual one tick early).
    ``push`` and ``read`` are split so the tick being
    PROPOSED reads its OWN type's floors/blend/dial — with a combined
    update the first tick of every turn would be proposed with the
    translation type's (typically fully annealed) floors, exactly the
    "enter the turn at the minimum floor" failure the per-type prior
    shrinkage exists to prevent.
    """

    def __init__(self, config):
        self.config = config
        win = config.floor_window
        self.rw_th = _TypedWindows(win)   # signed rotation residuals
        self.rw_al = _TypedWindows(win)   # signed along-track residuals
        self.rw_lat = _TypedWindows(win)  # squared lateral residuals
        self.qw_th = _TypedWindows(win)   # squared consistency samples
        self.qw_xy = _TypedWindows(win)
        self.first_tick = True

    def push(self, k, sr_th=None, sr_al=None, lat=None,
             d_ang=None, d_t2=None):
        """Ingest one tick's residuals under its tick type ``k``
        (None = unavailable, e.g. tick 0 has no previous scan and ticks
        0-1 no two-step pair)."""
        if sr_th is not None:
            self.rw_th.push(k, sr_th)
            self.rw_al.push(k, sr_al)
            self.rw_lat.push(k, lat ** 2)
        if d_ang is not None:
            # var(direct - composed) = 3 sigma^2; d_t2 sums two axes
            # (chi2_2-scaled — see _var2)
            self.qw_th.push(k, d_ang ** 2 / 3.0)
            self.qw_xy.push(k, d_t2 / 6.0)

    def read(self, k):
        """Outputs for an upcoming tick of type ``k`` (0 = rotation tick,
        1 = translation tick): ``(floor_xy, floor_th, blend_xy, blend_th,
        dial, diag)`` where ``dial`` is the fs2 proposal mode dial in
        [0, 1] (kernels.fastslam2_propose ``evidence_scale``)."""
        config = self.config
        lo, hi = config.proposal_floor_min, config.proposal_floor_max
        blend_min = config.blend_min_sigma

        # m shrinks toward the CONFIG PRIOR while this tick type has few
        # samples, never toward the other type's stats: under the
        # reference's rotation-XOR-translation odometry, translation ticks
        # carry NO information about rotation-tick slip — inheriting their
        # (tiny) moments would enter each turn at the minimum floor
        # exactly when an unseen slip regime can hit.  The prior's weight
        # decays to zero over the first ``n0`` samples of the type.  q
        # (matcher noise) is a property of the scans, not the regime, so
        # cross-type fallback there is safe.
        n0 = config.floor_prior_ticks
        th_w = self.rw_th.w[k]
        al_w = self.rw_al.w[k]
        b_th = float(np.median(th_w)) if th_w else 0.0
        b_al = float(np.median(al_w)) if al_w else 0.0
        lam_th = max(0.0, (n0 - len(th_w)) / n0)
        lam_al = max(0.0, (n0 - len(al_w)) / n0)
        # centered (debiased) second moments of the command error
        m_th_data = _var([(v - b_th) ** 2 for v in th_w])
        m_al_data = _var([(v - b_al) ** 2 for v in al_w])
        m_th = (lam_th * config.floor_prior_sigma_theta ** 2
                + (1 - lam_th) * m_th_data)
        m_al = (lam_al * config.floor_prior_sigma_xy ** 2
                + (1 - lam_al) * m_al_data)
        m_lat = _var(self.rw_lat.w[k]) if self.rw_lat.w[k] else m_al
        m_lat_data = _var(self.rw_lat.w[k]) if self.rw_lat.w[k] else m_al_data
        m_xy = (m_al + m_lat) / 2.0
        q_th = _var(self.qw_th.get(k))
        q_xy = _var2(self.qw_xy.get(k))
        # the bias estimate itself carries sampling error ~ pi/2 * m / n
        # (median of n samples); the debiased match error is white noise
        # plus that residue.  Data moments only — the config-prior portion
        # of m is not subject to bias-estimation error (with 1 sample the
        # term would exceed m itself and zero out the prior's floor).
        n_th = max(len(th_w), 1)
        n_al = max(len(al_w), 1)
        q_th_eff = q_th + 1.57 * m_th_data / n_th
        # the LATERAL residual is a second, correlation-robust estimate of
        # the matcher's translation noise: under the reference's
        # rotation-XOR-translation odometry the command has no lateral
        # freedom, so lateral ICP-vs-command residual is pure matcher
        # error.  The two-step consistency q samples only the matcher's
        # WHITE noise (the three matches share scans, so correlated error
        # partially cancels in the discrepancy); at high sensor noise that
        # under-subtraction read as phantom slip and held the floors/dial
        # open on clean commands (measured: noise-0.03 rows 0.065 vs
        # production 0.025).  Take the max of the two estimates.
        q_xy_eff = max(q_xy + 1.57 * m_al_data / n_al, m_lat_data)

        # command error variance (quadrature subtraction) and the MMSE
        # command-vs-ICP blend.  The blend is gated on the ABSOLUTE
        # estimated command error: measured regimes separate cleanly there
        # (clean-log worst case sigma ~ 0.006 from turn-time ICP noise the
        # consistency check under-subtracts; real slip >= 0.013) where the
        # m/q ratio does not (clean ratios reach 13 when both moments are
        # microscopic).  Below the gate, blending only pollutes near-exact
        # commands with scan-match noise (measured: clean ATE 0.09 with an
        # ungated blend vs 0.034 without).
        # subtract the matcher noise from the DATA portion only: the config
        # prior is a direct statement of the command-error sigma, not a
        # residual moment contaminated by matcher noise — with a prior near
        # the matcher-noise scale, subtracting q from it would zero the
        # unseen-type entry floor to the minimum (the exact failure the
        # prior exists to prevent).  The command error itself lives on the
        # ALONG-track axis (see the lateral rationale above), so the
        # along-track moment alone is the right basis; lateral matcher
        # noise must not inflate the floor.
        so_xy_d = max(m_al_data - q_xy_eff, 0.0)
        so_th_d = max(m_th_data - q_th_eff, 0.0)
        so_xy = (lam_al * config.floor_prior_sigma_xy ** 2
                 + (1 - lam_al) * so_xy_d)
        so_th = (lam_th * config.floor_prior_sigma_theta ** 2
                 + (1 - lam_th) * so_th_d)
        # blend only once the moment is data-driven (>= 4 samples): with
        # empty windows so equals the config prior and would spuriously
        # report "slip" before a single residual has been seen
        a_xy = (so_xy / max(m_al, 1e-12)
                if np.sqrt(so_xy) > blend_min and len(al_w) >= 4 else 0.0)
        # rotation blending is GATED, not banned (a revision of an earlier
        # "never blend" rule).  That rule's rationale stands below
        # the gate: the matcher's rotation estimate carries a systematic
        # bias (~4.3 mrad/tick measured) LARGER than its white noise, and
        # the windowed-median debias carries slip-contaminated sampling
        # error — on clean logs blending injects more than it removes, so
        # a_th stays 0 there.  But sustained ROTATION SLIP breaks the
        # trade: measured on the slip seed-3 drive
        # (eval_results/slip_diag_seed3_slip.json), a 31-rotation-tick
        # turn accumulated 0.113 rad of command error with n_meas ~= 1
        # (too few landmarks for the filter to absorb it via the open
        # floor) while the matcher tracked the slip to 3-6 mrad/tick —
        # the floor-only policy held that seed at 4x its siblings.  Above
        # ``blend_min_sigma_theta`` (set well above the bias scale) the
        # DEBIASED match is blended MMSE-style exactly like translation;
        # the floor then tracks the blended odometry's (much smaller)
        # error via the same (1-a)^2/a^2 formula.
        a_th = (so_th / max(m_th, 1e-12)
                if (np.sqrt(so_th) > config.blend_min_sigma_theta
                    and len(th_w) >= 4) else 0.0)
        # the floor must match the error of the odometry the filter will
        # actually receive — the BLENDED one: var((1-a) cmd + a icp') =
        # (1-a)^2 sigma_odo^2 + a^2 sigma_icp'^2.  At a=0 that is the
        # command error m - q; at the MMSE blend it collapses toward a*q —
        # with a slip-aware blend the proposal stays nearly as tight under
        # slip as on clean logs.
        fxy = float(np.clip(
            np.sqrt((1 - a_xy) ** 2 * so_xy + a_xy ** 2 * q_xy_eff), lo, hi))
        fth = float(np.clip(
            np.sqrt((1 - a_th) ** 2 * so_th + a_th ** 2 * q_th_eff), lo, hi))

        # fs2 proposal MODE DIAL, coupled to the FLOOR the proposal is
        # about to sample with.  Measurement-informed conditioning earns
        # its keep exactly when the proposal noise is wide — startup and
        # first-turn transients (per-type prior shrinkage holds the floor
        # near the config prior until the type has samples) and slip (the
        # floor tracks the blended odometry's error).  There, fs2 narrows
        # the sample around measurement-consistent poses; sampling a wide
        # floor WITHOUT conditioning is the worst of both (measured, seed-7
        # clean N=100 x3 rng: wide-floor motion-mode transient 0.049 vs
        # full-fs2-throughout 0.018 vs pure motion 0.013).  When the floor
        # is tight and commands near-exact, conditioning on noisy landmarks
        # only costs accuracy — ramp g to 0 and sample the reference's
        # motion model.  Ramping on the floors also subsumes explicit slip
        # detection: rotation slip opens the theta floor (never blended),
        # and translation slip either opens the xy floor or is absorbed by
        # the ICP blend (in which case the blended odometry is accurate and
        # motion-mode is right again).
        def _ramp(sig, lo_s, hi_s):
            return float(np.clip((sig - lo_s) / max(hi_s - lo_s, 1e-9),
                                 0.0, 1.0))

        g_xy = _ramp(fxy, config.fs2_dial_lo_floor, config.fs2_dial_hi_floor)
        g_th = _ramp(fth, config.fs2_dial_lo_floor, config.fs2_dial_hi_floor)
        dial = max(g_xy, g_th) if config.fs2_mode_dial else 1.0
        # per-tick match-failure gate for the blend: a tick whose LATERAL
        # residual (pure matcher error — see q_xy_eff rationale) exceeds
        # this many sigmas of the running lateral scale is a failed match
        # and must not be blended (config.blend_match_gate rationale)
        lat_gate = (config.blend_match_gate
                    * float(np.sqrt(max(m_lat, 1e-10))) + 1e-3)
        diag = {"m_xy": m_xy, "m_th": m_th, "q_xy": q_xy_eff,
                "q_th": q_th_eff, "b_tr": b_al, "b_th": b_th,
                "so_xy": so_xy_d, "so_th": so_th_d, "lat_gate": lat_gate}
        return fxy, fth, a_xy, a_th, dial, diag


def floor_schedule(sr_th, sr_al, lat, d_ang, d_t2, v_active, config):
    """Per-tick proposal floors, odometry blends, and ICP bias estimates
    for a whole recorded run (the batched replay path).

    Causal and online-identical: the values at tick t use residuals from
    ticks < t only (read-before-push — the same ordering as both online
    engines, so one log replayed batched or online traces the same
    floor/blend/dial trajectory)."""
    t_total = len(sr_th)
    floors_xy = np.empty(t_total, np.float32)
    floors_th = np.empty(t_total, np.float32)
    blend_xy = np.zeros(t_total, np.float32)
    blend_th = np.zeros(t_total, np.float32)
    bias_tr = np.zeros(t_total, np.float32)
    bias_th = np.zeros(t_total, np.float32)
    dial = np.zeros(t_total, np.float32)
    lat_gate = np.zeros(t_total, np.float32)
    diag = {key: np.zeros(t_total) for key in
            ("m_xy", "m_th", "q_xy", "q_th", "b_tr", "b_th",
             "so_xy", "so_th")}

    est = OnlineFloorEstimator(config)
    for t in range(t_total):
        k = int(v_active[t])
        res = (sr_th[t], sr_al[t], lat[t]) if t > 0 else (None, None, None)
        dd = (d_ang[t - 2], d_t2[t - 2]) \
            if d_ang is not None and t >= 2 else (None, None)
        fxy, fth, a_xy, a_th, g, dg = est.read(k)
        est.push(k, sr_th=res[0], sr_al=res[1], lat=res[2],
                 d_ang=dd[0], d_t2=dd[1])
        floors_xy[t], floors_th[t] = fxy, fth
        blend_xy[t], blend_th[t] = a_xy, a_th
        bias_tr[t], bias_th[t] = dg["b_tr"], dg["b_th"]
        dial[t] = g
        lat_gate[t] = dg["lat_gate"]
        for key in diag:
            diag[key][t] = dg[key]

    return FloorSchedule(floors_xy, floors_th, blend_xy, blend_th,
                         bias_tr, bias_th, dial, lat_gate, diag)
