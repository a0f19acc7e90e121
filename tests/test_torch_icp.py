"""The port's ``proposal/icp.py`` against the JAX package's, on the recorded
48-tick seed-3 drive: its 47 consecutive scan pairs, warm-started with the
command odometry as the replay does, in one batched call of the port
against ``jax.vmap`` of the JAX function.

``jnp.sum`` and ``torch.sum`` add the 180 points in other orders, so ICP is
held at a stated tolerance: theta and translation within atol 1e-5, the
mean error within rtol 1e-5, and the iteration counts equal.  The mean
error (~0.013 m) is an average of distances between points up to ~5 m from
the robot, whose float32 coordinates round at 2.4e-7 m (the spacing of
float32 in [2, 4)): it carries that absolute error too, so it is held at
rtol 1e-5 plus atol 2.4e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.proposal import icp as jax_icp

from fastslam_tpu_torch.app.runner import odometry, scan_points
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.drivers.replay import record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.interop import config_from_jax_fields
from fastslam_tpu_torch.proposal import icp

torch.set_num_threads(1)

JCFG = JaxConfig()
CFG = config_from_jax_fields(dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def pairs():
    """Warm-started (source, target, source_valid, target_valid) of the 47
    consecutive pairs, float32 numpy."""
    log = record_log(SimWorld(seed=3), num_ticks=48)
    pts, valid = scan_points(log)
    rots, trans = odometry(log, CFG)
    c, s = np.cos(-rots[1:]), np.sin(-rots[1:])
    src = pts[:-1]
    pre = np.stack([c[:, None] * src[..., 0] - s[:, None] * src[..., 1],
                    s[:, None] * src[..., 0] + c[:, None] * src[..., 1]], -1)
    pre[..., 0] -= trans[1:, None]
    return pre.astype(np.float32), pts[1:], valid[:-1], valid[1:]


def torch_args(pairs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in pairs)


def jax_batched(fn, pairs):
    return jax.jit(jax.vmap(lambda s, t, sv, tv: fn(s, t, sv, tv, JCFG)))(
        *(jnp.asarray(a) for a in pairs))


def assert_icp_matches(got, want):
    pick = np.asarray
    np.testing.assert_array_equal(got.num_iters.numpy(), pick(want.num_iters))
    np.testing.assert_allclose(got.theta.numpy(), pick(want.theta), atol=1e-5)
    np.testing.assert_allclose(got.translation.numpy(), pick(want.translation), atol=1e-5)
    np.testing.assert_allclose(got.rotation.numpy(), pick(want.rotation), atol=1e-5)
    np.testing.assert_allclose(got.mean_error.numpy(), pick(want.mean_error),
                               rtol=1e-5, atol=2.4e-7)


@pytest.mark.parametrize("name", ["icp_point_to_line", "icp"])
def test_batched_icp_matches_jax(pairs, name):
    want = jax_batched(getattr(jax_icp, name), pairs)
    got = getattr(icp, name)(*torch_args(pairs), CFG)
    assert got.theta.shape == (47,) and got.translation.shape == (47, 2)
    assert_icp_matches(got, want)
    # the drive moves: the matches do something, and each converged
    assert int(got.num_iters.max()) < CFG.icp_max_iterations
    assert int(got.num_iters.min()) >= 2


def test_one_pair_through_the_unbatched_path(pairs):
    k = 20
    one = tuple(a[k] for a in pairs)
    want = jax_icp.icp_point_to_line(*(jnp.asarray(a) for a in one), JCFG)
    got = icp.icp_point_to_line(*torch_args(one), CFG)
    assert got.theta.shape == () and got.translation.shape == (2,)
    assert_icp_matches(got, want)


def test_converged_pairs_stay_frozen(pairs):
    """Each pair of a batch ends where it ends alone: a batch that mixes
    pairs of different iteration counts gives every pair its own result."""
    batch = icp.icp_point_to_line(*torch_args(pairs), CFG)
    iters = batch.num_iters.numpy()
    assert len(set(iters.tolist())) > 1
    for k in (int(np.argmin(iters)), int(np.argmax(iters))):
        alone = icp.icp_point_to_line(*torch_args(tuple(a[k:k + 1] for a in pairs)), CFG)
        for f in ("theta", "translation", "num_iters", "mean_error"):
            assert torch.equal(getattr(alone, f)[0], getattr(batch, f)[k]), f


def test_max_iterations_caps_the_loop(pairs):
    cfg = CFG.replace(icp_max_iterations=2, icp_tolerance=0.0)
    jcfg = JCFG.replace(icp_max_iterations=2, icp_tolerance=0.0)
    got = icp.icp_point_to_line(*torch_args(pairs), cfg)
    want = jax.vmap(lambda s, t, sv, tv: jax_icp.icp_point_to_line(s, t, sv, tv, jcfg))(
        *(jnp.asarray(a) for a in pairs))
    assert (got.num_iters.numpy() == 2).all()
    assert_icp_matches(got, want)


def test_helpers_match_jax(pairs):
    src, tgt, sv, tv = pairs
    rng = np.random.default_rng(0)
    theta = rng.normal(0, 1, src.shape[0]).astype(np.float32)
    np.testing.assert_allclose(
        icp.rotate_points(torch.from_numpy(src), torch.from_numpy(theta)[:, None]).numpy(),
        np.asarray(jax.vmap(jax_icp.rotate_points)(jnp.asarray(src), jnp.asarray(theta))),
        atol=1e-5)
    np.testing.assert_allclose(
        icp.rotation_matrix(torch.from_numpy(theta)).numpy(),
        np.asarray(jax.vmap(jax_icp.rotation_matrix)(jnp.asarray(theta))), atol=1e-6)
    n_got, ok_got = icp.estimate_normals(torch.from_numpy(tgt), torch.from_numpy(tv))
    n_want, ok_want = jax.vmap(jax_icp.estimate_normals)(jnp.asarray(tgt), jnp.asarray(tv))
    np.testing.assert_array_equal(ok_got.numpy(), np.asarray(ok_want))
    np.testing.assert_allclose(n_got.numpy(), np.asarray(n_want), atol=1e-6)
    w = sv.astype(np.float32)
    for name in ("best_fit_angle", "best_fit_transform"):
        got = getattr(icp, name)(torch.from_numpy(src), torch.from_numpy(tgt),
                                 torch.from_numpy(w))
        want = jax.vmap(getattr(jax_icp, name))(jnp.asarray(src), jnp.asarray(tgt),
                                                jnp.asarray(w))
        for g, wv in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-5)


def test_icp_odometry_matches_jax(pairs):
    res = icp.icp_point_to_line(*torch_args(pairs), CFG)
    jres = jax_batched(jax_icp.icp_point_to_line, pairs)
    v = np.where(np.arange(47) % 3 == 0, 0.0, 0.3).astype(np.float32)
    got = icp.icp_odometry(res, torch.from_numpy(v))
    want = jax.vmap(jax_icp.icp_odometry)(jres, jnp.asarray(v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert (got[0].numpy()[v != 0] == 0).all() and (got[1].numpy()[v == 0] == 0).all()
