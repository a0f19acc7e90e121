"""The port's distributed Schur backend (``backend/distributed.py``) on a map
mesh of CPU shards.

* ``shard_pose_graph`` and ``build_schur_pairs`` equal JAX's exactly.
* The SPARSE step at S = 8 against JAX's ``make_sharded_gn_step`` on its
  8-device virtual CPU mesh (``tests/conftest.py``; the one JAX call on that
  mesh in this file): poses within rtol = atol = 1e-4, landmarks within
  atol = 1e-3 (``tests/test_backend_distributed.py``'s bars).
* The same step at S = 8 against S = 1 and the single-device
  ``gauss_newton_step`` at the same bars, and ``optimize_sharded`` recovers
  the trajectory (``after < 0.6 * before``).
The dense step is ``test_torch_backend_dense.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fastslam_tpu.backend import builder as jax_builder
from fastslam_tpu.backend import distributed as jax_dist

from fastslam_tpu_torch.backend import builder, distributed, pose_graph
from fastslam_tpu_torch.parallel import dryrun
from fastslam_tpu_torch.parallel.collectives import psum
from fastslam_tpu_torch.parallel.mesh import make_map_mesh
from tests.test_backend import simulate_world

torch.set_num_threads(1)

DAMP = 1e-4


def make_graphs(seed=2, k=12, drift=0.4, max_landmarks=16, max_factors=512):
    noisy, obs, gt, _ = simulate_world(k=k, drift=drift, seed=seed)
    kw = dict(max_landmarks=max_landmarks, max_factors=max_factors)
    return (jax_builder.build_pose_graph(noisy, obs, **kw),
            builder.build_pose_graph(noisy, obs, device="cpu", **kw), gt)


def same(got, want):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                  np.asarray(want))


def sparse_columns(g):
    """The sparse step's column arguments of a sharded port graph."""
    c = lambda t: t.contiguous()
    return (g.poses, c(g.landmarks[:, 0]), c(g.landmarks[:, 1]), g.odo_rel, g.odo_info,
            g.odo_valid, g.obs_kf, g.obs_lm, c(g.obs_rb[:, 0]), c(g.obs_rb[:, 1]),
            c(g.obs_info[:, 0]), c(g.obs_info[:, 1]), g.obs_valid, g.prior_info)


def port_sparse_step(g, shards):
    mesh = make_map_mesh(["cpu"] * shards)
    gs, dropped = distributed.shard_pose_graph(g, shards)
    assert dropped == 0
    step = distributed.make_sharded_gn_step(mesh, sparse=True)
    p, lx, ly = step(*sparse_columns(gs), torch.tensor(DAMP),
                     *distributed.build_schur_pairs(gs, shards))
    return p, torch.stack([lx, ly], -1)


def sorted_rows(landmarks):
    """Landmark rows as a sorted multiset at 4 decimals (sharding permutes
    factors; the comparison stays order-free as in the JAX test)."""
    return np.sort(np.round(np.asarray(landmarks), 4).reshape(-1, 2), axis=0)


@pytest.mark.parametrize("shards", [8, 3, 1])
def test_shard_pose_graph_and_pairs_equal_jax(shards):
    gj, gt_, _ = make_graphs(max_factors=504)
    if gt_.landmarks.shape[0] % shards:
        gj, gt_, _ = make_graphs(max_landmarks=18, max_factors=504)
    got, dropped = distributed.shard_pose_graph(gt_, shards)
    want, want_dropped = jax_dist.shard_pose_graph(gj, shards)
    assert dropped == want_dropped == 0
    for name, g, w in zip(want._fields, got, want):
        same(g, w)
    for g, w in zip(distributed.build_schur_pairs(got, shards),
                    jax_dist.build_schur_pairs(want, shards)):
        same(g, w)


def test_shard_overflow_drops_and_warns_as_jax():
    noisy, obs, _, _ = simulate_world(k=12, drift=0.4, seed=2)
    # 2 landmark slots and 16 factor slots per shard: the first shards'
    # landmarks have more factors than that
    kw = dict(max_landmarks=16, max_factors=128)
    gj = jax_builder.build_pose_graph(noisy, obs, **kw)
    gt_ = builder.build_pose_graph(noisy, obs, device="cpu", **kw)
    with pytest.warns(UserWarning, match="DROPPED"):
        want, want_dropped = jax_dist.shard_pose_graph(gj, 8)
    with pytest.warns(UserWarning, match="DROPPED"):
        got, dropped = distributed.shard_pose_graph(gt_, 8)
    assert dropped == want_dropped > 0
    for g, w in zip(got, want):
        same(g, w)


def test_sparse_step_at_8_shards_matches_jax_mesh():
    gj, gt_, _ = make_graphs()
    devs = np.asarray(jax.devices())
    assert len(devs) == 8, "conftest should provide 8 virtual devices"
    mesh = Mesh(devs, ("map",))
    g8, _ = jax_dist.shard_pose_graph(gj, 8)
    pair_a, pair_b, pair_valid = jax_dist.build_schur_pairs(g8, 8)
    rb = np.asarray(g8.obs_rb, np.float32)
    wi = np.asarray(g8.obs_info, np.float32)
    lm = np.asarray(g8.landmarks, np.float32)
    step = jax_dist.make_sharded_gn_step(mesh, sparse=True)
    p_want, lx, ly = step(
        jnp.asarray(np.asarray(g8.poses, np.float32)),
        jnp.asarray(lm[:, 0].copy()), jnp.asarray(lm[:, 1].copy()),
        jnp.asarray(g8.odo_rel), jnp.asarray(g8.odo_info), jnp.asarray(g8.odo_valid),
        jnp.asarray(np.asarray(g8.obs_kf, np.int32)), jnp.asarray(np.asarray(g8.obs_lm, np.int32)),
        jnp.asarray(rb[:, 0].copy()), jnp.asarray(rb[:, 1].copy()),
        jnp.asarray(wi[:, 0].copy()), jnp.asarray(wi[:, 1].copy()),
        jnp.asarray(np.asarray(g8.obs_valid)), jnp.asarray(g8.prior_info),
        jnp.float32(DAMP), pair_a, pair_b, pair_valid)
    l_want = np.stack([np.asarray(lx), np.asarray(ly)], axis=-1)
    p_got, l_got = port_sparse_step(gt_, 8)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sorted_rows(l_got.numpy()), sorted_rows(l_want), atol=1e-3)


def test_sparse_step_8_shards_vs_1_and_single_device():
    _, gt_, _ = make_graphs(seed=5, k=16, drift=0.5)
    p_one, l_one = pose_graph.gauss_newton_step(gt_.poses, gt_.landmarks, gt_, DAMP)
    p8, l8 = port_sparse_step(gt_, 8)
    p1, l1 = port_sparse_step(gt_, 1)
    for p in (p8, p1):
        np.testing.assert_allclose(p.numpy(), p_one.numpy(), rtol=1e-4, atol=1e-4)
    for l in (l8, l1):    # landmark slots keep their order: row by row
        np.testing.assert_allclose(l.numpy(), l_one.numpy(), atol=1e-3)


@pytest.mark.parametrize("sparse", [True, False])
def test_optimize_sharded_recovers_trajectory(sparse):
    _, g, gt = make_graphs(seed=5, k=16, drift=0.5)
    before = np.linalg.norm(g.poses.numpy()[:, :2] - gt[:, :2], axis=1).mean()
    poses, landmarks, err = distributed.optimize_sharded(
        g, make_map_mesh(["cpu"] * 8), num_iters=12, sparse=sparse)
    after = np.linalg.norm(poses.numpy()[:, :2] - gt[:, :2], axis=1).mean()
    assert np.isfinite(err) and landmarks.shape == g.landmarks.shape
    assert after < before * 0.6, f"{before:.4f} -> {after:.4f}"


def test_total_error_host_equals_jax():
    gj, gt_, _ = make_graphs()
    g8j, _ = jax_dist.shard_pose_graph(gj, 8)
    g8t, _ = distributed.shard_pose_graph(gt_, 8)
    lm = np.asarray(g8j.landmarks)
    want = jax_dist.total_error_host(np.asarray(g8j.poses), lm[:, 0], lm[:, 1], g8j)
    got = distributed.total_error_host(g8t.poses, g8t.landmarks[:, 0], g8t.landmarks[:, 1],
                                       g8t)
    assert got == want


def test_float_psum_adds_in_shard_order():
    vals = [torch.tensor([1e8, 1.0]), torch.tensor([1.0, 1e8]), torch.tensor([-1e8, -1e8])]
    assert torch.equal(psum(vals), (vals[0] + vals[1]) + vals[2])
    assert psum([torch.tensor(True), torch.tensor(False)]).dtype == torch.int64


def test_map_mesh():
    assert make_map_mesh(["cpu"] * 4).num_shards == 4
    with pytest.raises(NotImplementedError):
        make_map_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        make_map_mesh([])


def test_backend_dry_run_at_8_shards():
    out = dryrun.dryrun_backend(8, "cpu")
    assert out["poses"].shape == (8, 3) and np.isfinite(out["err"])
    assert out["launches"] == {"segment_sum": 0}
