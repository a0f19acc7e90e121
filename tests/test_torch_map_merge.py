"""The port's multi-session map merge (``backend/map_merge.py``) against
``fastslam_tpu.backend.map_merge`` on ``tests/test_map_merge.py:make_maps``
pairs: the alignment's rotation and translation within 1e-4 and the same
``num_matched``; the merge's matched / appended / dropped masks and valid
flags equal, its landmarks within 1e-4; and ``refine_merged_sessions``
meeting ``test_map_merge.py``'s bars (each session's drift at most half).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.backend import map_merge as jax_mm

from fastslam_tpu_torch.backend import map_merge
from tests.test_backend import simulate_world
from tests.test_map_merge import make_maps

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
MAPS = {   # make_maps arguments
    "known": dict(seed=1),
    "partial_overlap": dict(seed=2, n_shared=10, n_a_only=8, n_b_only=8),
    "fuse": dict(seed=3),
    "capacity": dict(seed=4, cap=18),
    "end_to_end": dict(seed=5),
    "wide": dict(seed=11, n_shared=300, n_a_only=60, n_b_only=40, cap=512,
                 theta=0.12, tx=0.3, ty=-0.2),
}


ALIGNED = ("known", "partial_overlap", "wide")


def both(name):
    lm_a, va, lm_b, vb, truth = make_maps(**MAPS[name])
    t = lambda x: torch.tensor(np.asarray(x))
    return (lm_a, va, lm_b, vb), tuple(t(x) for x in (lm_a, va, lm_b, vb)), truth


@pytest.mark.parametrize("name", sorted(MAPS))
def test_alignment_equals_jax(name):
    jargs, targs, (rot, trans) = both(name)
    want = jax_mm.align_landmark_maps(jargs[2], jargs[3], jargs[0], jargs[1])
    got = map_merge.align_landmark_maps(targs[2], targs[3], targs[0], targs[1])
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), **TOL)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), **TOL)
    np.testing.assert_allclose(float(got.mean_residual), float(want.mean_residual), **TOL)
    assert int(got.num_matched) == int(want.num_matched)
    if name in ALIGNED:     # the cases JAX's own tests align
        np.testing.assert_allclose(got.rotation.numpy(), rot, atol=0.05)


@pytest.mark.parametrize("name", sorted(MAPS))
@pytest.mark.parametrize("weight_a", [1.0, 2.0])
def test_merge_equals_jax(name, weight_a):
    jargs, targs, (rot, trans) = both(name)
    jb = jax_mm.transform_points(jargs[2], jnp.asarray(rot, jnp.float32),
                                 jnp.asarray(trans, jnp.float32))
    tb = map_merge.transform_points(targs[2], torch.tensor(rot, dtype=torch.float32),
                                    torch.tensor(trans, dtype=torch.float32))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    want = jax_mm.merge_landmark_maps(jargs[0], jargs[1], jb, jargs[3], gate=0.4,
                                      weight_a=weight_a)
    got = map_merge.merge_landmark_maps(targs[0], targs[1], tb, targs[3], gate=0.4,
                                        weight_a=weight_a)
    for field in ("valid", "matched_b", "appended_b", "dropped_b"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_allclose(got.landmarks.numpy(), np.asarray(want.landmarks), **TOL)


def test_merge_sessions_end_to_end_equals_jax():
    jargs, targs, _ = both("end_to_end")
    poses_b = np.array([[0.0, 0.0, 0.0], [1.0, 0.5, 0.4], [-2.0, 1.0, 3.1]], np.float32)
    al_j, m_j, p_j = jax_mm.merge_sessions(*jargs, jnp.asarray(poses_b))
    al_t, m_t, p_t = map_merge.merge_sessions(*targs, torch.tensor(poses_b))
    np.testing.assert_allclose(al_t.translation.numpy(), np.asarray(al_j.translation), **TOL)
    np.testing.assert_array_equal(m_t.valid.numpy(), np.asarray(m_j.valid))
    assert int(m_t.valid.sum()) == 19
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), **TOL)
    assert map_merge.merge_sessions(*targs)[2] is None


def test_joint_refinement_corrects_per_session_drift():
    noisy_a, obs_a, gt, _ = simulate_world(k=14, drift=0.8, seed=31)
    rng = np.random.default_rng(99)
    noisy_b = gt + rng.normal(0, 0.8 / 14, (14, 3)).cumsum(axis=0)
    noisy_b[0] = gt[0]
    err_in_a = np.linalg.norm(noisy_a[:, :2] - gt[:, :2], axis=1).mean()
    err_in_b = np.linalg.norm(noisy_b[:, :2] - gt[:, :2], axis=1).mean()
    ref_a, ref_b, info = map_merge.refine_merged_sessions(
        noisy_a, obs_a, noisy_b, obs_a, max_landmarks=32, max_factors=1024,
        association_gate=0.6, device="cpu")
    err_a = np.linalg.norm(ref_a[:, :2] - gt[:, :2], axis=1).mean()
    err_b = np.linalg.norm(ref_b[:, :2] - gt[:, :2], axis=1).mean()
    assert err_a < err_in_a * 0.5, (err_in_a, err_a)
    assert err_b < err_in_b * 0.5, (err_in_b, err_b)
    assert np.isfinite(info["final_error"]) and info["num_factors"] > 0
