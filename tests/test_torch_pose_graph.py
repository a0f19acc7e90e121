"""The port's pose-graph optimizer (``fastslam_tpu_torch/backend/pose_graph.py``)
against ``fastslam_tpu.backend.pose_graph`` on the graphs of
``tests/test_backend.py:simulate_world``, built by each package's builder
from the same numpy inputs (the graphs are equal exactly,
``test_torch_backend_builder.py``).

Floats at rtol = atol = 1e-4: the port sums in another order (segment sums
in place of XLA's scatter-adds) and evaluates ``atan2`` in float64.  The
optimizer must meet ``tests/test_backend.py``'s bar (``after < 0.6 *
before``, a non-increasing history) and end within 1e-3 relative of JAX's
final error; a step that is not positive definite is rejected as in JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.backend import builder as jax_builder
from fastslam_tpu.backend import pose_graph as jax_pg
from fastslam_tpu.backend.distributed import build_schur_pairs as jax_build_schur_pairs

from fastslam_tpu_torch.backend import builder, pose_graph
from fastslam_tpu_torch.backend.distributed import build_schur_pairs
from fastslam_tpu_torch.interop import pose_graph_from_numpy
from tests.test_backend import simulate_world

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
GRAPHS = {  # simulate_world arguments and builder capacities
    "mild": (dict(k=12, drift=0.4, seed=1), dict(max_landmarks=16, max_factors=256)),
    "loop16": (dict(k=16, drift=0.5, seed=2), dict(max_landmarks=16, max_factors=512)),
    "heavy": (dict(k=16, drift=1.4, seed=7), dict(max_landmarks=32, max_factors=512,
                                                 association_gate=0.6)),
}


def graphs(name):
    world, caps = GRAPHS[name]
    noisy, obs, gt, _ = simulate_world(**world)
    return (jax_builder.build_pose_graph(noisy, obs, **caps),
            builder.build_pose_graph(noisy, obs, device="cpu", **caps), gt)


def close(got, want, **tol):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), **(tol or TOL))


def flat(outputs):
    out = []
    for x in outputs:
        out.extend(x if isinstance(x, tuple) else (x,))
    return out


def test_wrap_angle_matches_jnp_remainder():
    a = np.linspace(-20.0, 20.0, 4001, dtype=np.float32)
    a = np.concatenate([a, np.float32([np.pi, -np.pi, 3 * np.pi, 0.0])])
    close(pose_graph.wrap_angle(torch.tensor(a)), jax_pg.wrap_angle(jnp.asarray(a)),
          rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_total_error_and_pose_system(name):
    gj, gt_, _ = graphs(name)
    close(pose_graph.total_error(gt_.poses, gt_.landmarks, gt_),
          jax_pg.total_error(gj.poses, gj.landmarks, gj))
    for got, want in zip(pose_graph.pose_system(gt_.poses, gt_, 1e-4),
                         jax_pg.pose_system(gj.poses, gj, jnp.float32(1e-4))):
        close(got, want)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_schur_normal_equations(name):
    gj, gt_, _ = graphs(name)
    got = pose_graph.schur_normal_equations(gt_.poses, gt_.landmarks, gt_, 1e-4)
    want = jax_pg.schur_normal_equations(gj.poses, gj.landmarks, gj, jnp.float32(1e-4))
    for g, w in zip(got, want):
        close(g, w)
    # the dense back-substitution on the same inputs
    dp = torch.tensor(np.random.default_rng(0).normal(0, 0.01, (gj.poses.shape[0], 3)),
                      dtype=torch.float32)
    close(pose_graph.backsubstitute_landmarks(dp, *got[2:]),
          jax_pg.backsubstitute_landmarks(jnp.asarray(dp.numpy()), *want[2:]))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_landmark_system_sparse_and_backsubstitution(name):
    gj, gt_, _ = graphs(name)
    pa, pb, pv = jax_build_schur_pairs(gj, 1)
    rb, wi, lm = (np.asarray(x) for x in (gj.obs_rb, gj.obs_info, gj.landmarks))
    cols = (lm[:, 0], lm[:, 1])
    factor_cols = (rb[:, 0], rb[:, 1], wi[:, 0], wi[:, 1])
    want = jax_pg.landmark_system_sparse(
        gj.poses, *(jnp.asarray(c) for c in cols), jnp.float32(1e-4), gj.obs_kf, gj.obs_lm,
        *(jnp.asarray(c) for c in factor_cols), gj.obs_valid, pa, pb, pv)
    t = lambda c: torch.tensor(np.ascontiguousarray(c))
    ports = build_schur_pairs(gt_, 1)
    for a, b in zip(ports, (pa, pb, pv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = pose_graph.landmark_system_sparse(
        gt_.poses, *(t(c) for c in cols), 1e-4, gt_.obs_kf, gt_.obs_lm,
        *(t(c) for c in factor_cols), gt_.obs_valid, *ports)
    for g, w in zip(flat(got), flat(want)):
        close(g, w)
    dp = np.random.default_rng(1).normal(0, 0.01, (gj.poses.shape[0], 3)).astype(np.float32)
    l = lm.shape[0]
    want_dl = jax_pg.backsubstitute_landmarks_sparse(jnp.asarray(dp), want[4], want[5], want[6],
                                                     gj.obs_kf, gj.obs_lm, l)
    got_dl = pose_graph.backsubstitute_landmarks_sparse(torch.tensor(dp), got[4], got[5], got[6],
                                                        gt_.obs_kf, gt_.obs_lm, l)
    for g, w in zip(got_dl, want_dl):
        close(g, w)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gauss_newton_step(name):
    gj, gt_, _ = graphs(name)
    pj, lj = jax_pg.gauss_newton_step(gj.poses, gj.landmarks, gj, jnp.float32(1e-4))
    pt, lt = pose_graph.gauss_newton_step(gt_.poses, gt_.landmarks, gt_, 1e-4)
    close(pt, pj)
    close(lt, lj)


def test_optimize_recovers_trajectory_and_matches_jax():
    gj, gt_, gt = graphs("loop16")
    noisy = gt_.poses.numpy()
    before = np.linalg.norm(noisy[:, :2] - gt[:, :2], axis=1).mean()
    poses, landmarks, err, hist = pose_graph.optimize(gt_, num_iters=15)
    after = np.linalg.norm(poses.numpy()[:, :2] - gt[:, :2], axis=1).mean()
    assert np.isfinite(float(err))
    assert after < before * 0.6, f"mean pos err {before:.4f} -> {after:.4f}"
    assert (np.diff(hist.numpy()) <= 1e-6).all()
    _, _, err_j, _ = jax_pg.optimize(gj, num_iters=15)
    assert abs(float(err) - float(err_j)) <= 1e-3 * abs(float(err_j))


def isolated_keyframe_graphs(j=5):
    """The "mild" graph with keyframe ``j`` cut loose (its observations and
    both odometry factors invalid): at zero damping its block of S is zero,
    so the Cholesky factorisation fails."""
    gj, gt_, _ = graphs("mild")
    arrays = {k: np.array(v) for k, v in gj._asdict().items()}
    arrays["obs_valid"] &= arrays["obs_kf"] != j
    arrays["odo_valid"][[j - 1, j]] = False
    return (jax_pg.PoseGraph(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            pose_graph_from_numpy(arrays, "cpu"))


def test_non_positive_definite_step_is_rejected_as_in_jax():
    gj, gt_ = isolated_keyframe_graphs()
    pj, _ = jax_pg.gauss_newton_step(gj.poses, gj.landmarks, gj, jnp.float32(0.0))
    pt, _ = pose_graph.gauss_newton_step(gt_.poses, gt_.landmarks, gt_, 0.0)
    assert not np.isfinite(np.asarray(pj)).all()
    assert torch.isnan(pt).all()
    # every step fails (lambda stays 0): the input comes back, error unchanged
    poses_j, lms_j, err_j, hist_j = jax_pg.optimize(gj, num_iters=4, damping=0.0)
    poses, lms, err, hist = pose_graph.optimize(gt_, num_iters=4, damping=0.0)
    assert torch.equal(poses, gt_.poses) and torch.equal(lms, gt_.landmarks)
    np.testing.assert_array_equal(np.asarray(poses_j), np.asarray(gj.poses))
    err0 = pose_graph.total_error(gt_.poses, gt_.landmarks, gt_)
    assert torch.equal(hist, err0.repeat(4)) and torch.equal(err, err0)
    close(err, err_j)
    # a positive damping makes the isolated block positive definite again
    poses, _, err, _ = pose_graph.optimize(gt_, num_iters=4, damping=1e-3)
    assert torch.isfinite(poses).all() and float(err) < float(err0)


def test_invalid_factors_are_inert():
    noisy, obs, _, _ = simulate_world(k=8, drift=0.2, seed=4)
    g = builder.build_pose_graph(noisy, obs, max_landmarks=16, max_factors=128, device="cpu")
    n_valid = int(g.obs_valid.sum())
    rb = g.obs_rb.clone()
    rb[n_valid:] = 1e3
    g2 = g._replace(obs_rb=rb)
    assert float(pose_graph.total_error(g.poses, g.landmarks, g)) == pytest.approx(
        float(pose_graph.total_error(g2.poses, g2.landmarks, g2)))
    p1, _ = pose_graph.gauss_newton_step(g.poses, g.landmarks, g, 1e-4)
    p2, _ = pose_graph.gauss_newton_step(g2.poses, g2.landmarks, g2, 1e-4)
    assert torch.equal(p1, p2)
