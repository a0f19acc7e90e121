"""The serpentine survey world of BASELINE config #5: a copy of
``scripts/bench_backend_1m.py:survey_world_chunked`` (numpy), which the
port's smoke run builds its 1.1M-landmark graph from.  The same seed gives
the same arrays as the script's.
"""

from __future__ import annotations

import numpy as np


def survey_world_chunked(n_landmarks, k=256, spacing=4.0, sigma_xy=0.05,
                         sigma_th=0.001, seed=0):
    """Serpentine survey like tests/test_backend_scale.survey_world, with the
    landmark->nearest-keyframes search done by GRID LOOKUP: keyframes sit on
    a regular rows x cols lattice, so each landmark's two nearest keyframes
    are among the 3x3 lattice neighborhood of its grid cell — 9 candidate
    distances per landmark instead of k (exact for a lattice).

    Landmarks sit on a JITTERED GRID (``spacing`` ± spacing/4), which
    guarantees >= spacing/2 separation between distinct landmarks — so an
    association gate well below spacing/2 can merge the two observations of
    the SAME landmark (relative drift between its two observing keyframes,
    ~sigma_xy*sqrt(steps)) without ever merging different ones.  A uniform
    scatter has no such floor (mean NN distance 0.5/sqrt(density)); at 1M
    landmarks it forces the gate below the drift scale, every cross-row
    observation pair splits, and the graph ends up with no loop closures to
    optimize.

    Returns (noisy poses [K,3], per-keyframe obs list, ground truth [K,3],
    field side length)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_landmarks)))
    field = side * spacing
    rows = int(np.sqrt(k))
    cols = k // rows
    gt = np.zeros((rows * cols, 3))
    for r in range(rows):
        cs = np.linspace(0.0, field, cols)
        if r % 2:
            cs = cs[::-1]
        gt[r * cols: (r + 1) * cols, 0] = cs
        gt[r * cols: (r + 1) * cols, 1] = r * field / max(rows - 1, 1)
        gt[r * cols: (r + 1) * cols, 2] = 0.0 if r % 2 == 0 else np.pi
    k = rows * cols

    gxy = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                               indexing="ij"), axis=-1).reshape(-1, 2)
    lms = (gxy[:n_landmarks] * spacing + spacing / 2
           + rng.uniform(-spacing / 4, spacing / 4, (n_landmarks, 2)))
    # lattice coordinates of each landmark's containing keyframe cell; the
    # serpentine flips column order on odd rows, so map (row, col) back to
    # the keyframe index through the flip
    col_dx = field / max(cols - 1, 1)
    row_dy = field / max(rows - 1, 1)
    r0 = np.clip(np.round(lms[:, 1] / row_dy).astype(np.int64), 0, rows - 1)
    c0 = np.clip(np.round(lms[:, 0] / col_dx).astype(np.int64), 0, cols - 1)
    cand_d2 = np.full((n_landmarks, 9), np.inf)
    cand_idx = np.zeros((n_landmarks, 9), np.int64)
    col = 0
    for orr in (-1, 0, 1):
        for oc in (-1, 0, 1):
            rr = r0 + orr
            cc = c0 + oc
            ok = (rr >= 0) & (rr < rows) & (cc >= 0) & (cc < cols)
            rr_c = np.clip(rr, 0, rows - 1)
            cc_c = np.clip(cc, 0, cols - 1)
            cc_serp = np.where(rr_c % 2 == 1, cols - 1 - cc_c, cc_c)
            idx = rr_c * cols + cc_serp
            d2 = ((lms[:, 0] - gt[idx, 0]) ** 2
                  + (lms[:, 1] - gt[idx, 1]) ** 2)
            cand_d2[:, col] = np.where(ok, d2, np.inf)
            cand_idx[:, col] = idx
            col += 1
    two = np.argpartition(cand_d2, 2, axis=1)[:, :2]
    nearest2 = np.take_along_axis(cand_idx, two, axis=1)

    kf_idx = nearest2.reshape(-1)
    lm_idx = np.repeat(np.arange(n_landmarks), 2)
    dx = lms[lm_idx, 0] - gt[kf_idx, 0]
    dy = lms[lm_idx, 1] - gt[kf_idx, 1]
    r = np.hypot(dx, dy) + rng.normal(0, 0.01, len(kf_idx))
    b = np.arctan2(dy, dx) - gt[kf_idx, 2] + rng.normal(0, 1e-3, len(kf_idx))
    b = (b + np.pi) % (2 * np.pi) - np.pi

    order = np.argsort(kf_idx, kind="stable")
    counts = np.bincount(kf_idx, minlength=k)
    splits = np.cumsum(counts)[:-1]
    obs = np.split(np.stack([r, b], -1)[order], splits)

    noise = np.stack([
        rng.normal(0, sigma_xy, k), rng.normal(0, sigma_xy, k),
        rng.normal(0, sigma_th, k),
    ], axis=-1).cumsum(axis=0)
    noisy = gt + noise
    noisy[0] = gt[0]
    return noisy, obs, gt, field
