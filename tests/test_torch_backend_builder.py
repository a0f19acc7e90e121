"""The port's numpy copies of the backend's graph construction
(``backend/builder.py``, ``backend/alignment.py``, ``backend/survey.py``)
against ``fastslam_tpu.backend``: every output equal exactly
(``np.array_equal``), the graphs field by field.

Also the one change the port makes: ``alignment._pairs_within`` warns,
naming how many candidates it cut, whenever its per-point cap binds, and
returns the same pairs as the reference; and the interop of a graph between
the packages.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

from fastslam_tpu.backend import alignment as jax_alignment
from fastslam_tpu.backend import builder as jax_builder

from fastslam_tpu_torch.backend import alignment, builder
from fastslam_tpu_torch.backend.survey import survey_world_chunked
from fastslam_tpu_torch.interop import pose_graph_from_numpy, pose_graph_to_numpy
from tests.test_backend import simulate_world

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from bench_backend_1m import survey_world_chunked as script_survey_world  # noqa: E402

torch.set_num_threads(1)


def assert_same_graph(got, want):
    for name, g, w in zip(want._fields, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def drifted_world(seed=8, drift=2.5):
    noisy, obs, gt, gt_lms = simulate_world(k=16, drift=drift, seed=seed)
    ids = []
    for i in range(len(gt)):
        d = gt_lms - gt[i, :2]
        ids.append(np.flatnonzero(np.hypot(d[:, 0], d[:, 1]) < 5.0))
    return noisy, obs, ids


BUILDS = {
    "greedy": dict(max_landmarks=16, max_factors=256),
    "grid": dict(max_landmarks=32, max_factors=256, association="grid",
                 association_gate=0.6),
    "ids": dict(max_landmarks=32, max_factors=512, ids=True),
    "session_boundary": dict(max_landmarks=16, max_factors=256, session_boundaries=(6,),
                             odo_sigma_xy=0.2, obs_sigma_b=0.01),
    "association_poses": dict(max_landmarks=32, max_factors=512, association_gate=0.5,
                              association_poses=True),
    "landmark_capacity": dict(max_landmarks=4, max_factors=256),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_pose_graph_equals_jax(name):
    kw = dict(BUILDS[name])
    noisy, obs, ids = drifted_world(seed=3, drift=0.3)
    if kw.pop("ids", False):
        kw["measurement_ids"] = ids
    if kw.pop("association_poses", False):
        kw["association_poses"] = noisy + np.random.default_rng(0).normal(0, 0.02, noisy.shape)
    want = jax_builder.build_pose_graph(noisy, obs, **kw)
    got = builder.build_pose_graph(noisy, obs, device="cpu", **kw)
    assert_same_graph(got, want)
    assert got.poses.device.type == "cpu"


def test_factor_overflow_warns_as_jax():
    noisy, obs, _ = drifted_world(seed=3, drift=0.3)
    with pytest.warns(UserWarning, match="observation factors dropped"):
        want = jax_builder.build_pose_graph(noisy, obs, max_landmarks=16, max_factors=40)
    with pytest.warns(UserWarning, match="observation factors dropped"):
        got = builder.build_pose_graph(noisy, obs, max_landmarks=16, max_factors=40,
                                       device="cpu")
    assert_same_graph(got, want)


@pytest.mark.parametrize("rounds", [1, 2])
def test_reassociate_and_reinit_equal_jax(rounds):
    noisy, obs, ids = drifted_world()
    gj = jax_builder.build_pose_graph(noisy, obs, max_landmarks=32, max_factors=512,
                                      association_gate=0.6)
    gt_ = builder.build_pose_graph(noisy, obs, max_landmarks=32, max_factors=512,
                                   association_gate=0.6, device="cpu")
    rng = np.random.default_rng(rounds)
    for _ in range(rounds):
        poses = np.asarray(gj.poses) + rng.normal(0, 0.05, gj.poses.shape).astype(np.float32)
        gj = jax_builder.reassociate_pose_graph(gj, poses, association_gate=0.6)
        gt_ = builder.reassociate_pose_graph(gt_, torch.tensor(poses), association_gate=0.6)
        assert_same_graph(gt_, gj)
    gi_j = jax_builder.build_pose_graph(noisy, obs, measurement_ids=ids, max_landmarks=32,
                                        max_factors=512)
    gi_t = builder.build_pose_graph(noisy, obs, measurement_ids=ids, max_landmarks=32,
                                    max_factors=512, device="cpu")
    poses = noisy[:, :] + rng.normal(0, 0.05, noisy.shape)
    assert_same_graph(builder.reinit_landmarks(gi_t, poses),
                      jax_builder.reinit_landmarks(gi_j, poses))


def test_survey_world_is_the_scripts():
    got = survey_world_chunked(3000, k=64, sigma_xy=0.05, seed=1)
    want = script_survey_world(3000, k=64, sigma_xy=0.05, seed=1)
    for g, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        np.testing.assert_array_equal(g, w)
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)


def test_register_clouds_and_candidate_pairs_equal_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.0, 60.0, (400, 2))
    rel = pts - pts.mean(axis=0)
    wb = (pts + np.array([1.3, -0.9]) + 0.004 * np.stack([-rel[:, 1], rel[:, 0]], -1)
          + rng.normal(0, 0.05, pts.shape))
    wa = np.concatenate([pts, rng.uniform(0.0, 60.0, (200, 2))])
    wb = np.concatenate([wb, rng.uniform(0.0, 60.0, (200, 2))])
    kw = dict(omega_candidates=(-0.004, 0.0, 0.004), axis=np.array([1.0, 0.3]),
              window_perp=7.0)
    got = alignment.register_clouds(wa, wb, **kw)
    want = jax_alignment.register_clouds(wa, wb, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert alignment.register_clouds(wa, wb + 300.0) is None
    for k in (300, 4200):                 # the dense matrix and the grid sweep
        kf = rng.uniform(0.0, 400.0, (k, 3))
        np.testing.assert_array_equal(alignment.candidate_pairs(kf, radius=12.0),
                                      jax_alignment.candidate_pairs(kf, radius=12.0))


@pytest.mark.parametrize("boundaries", [(), (32,)])
def test_consensus_align_equals_jax(boundaries):
    noisy, obs, gt, _ = survey_world_chunked(5000, k=64, sigma_xy=0.05, seed=1)
    got, info = alignment.consensus_align(noisy, obs, sigma_xy=0.05, sigma_theta=0.001,
                                          session_boundaries=boundaries)
    want, want_info = jax_alignment.consensus_align(noisy, obs, sigma_xy=0.05,
                                                    sigma_theta=0.001,
                                                    session_boundaries=boundaries)
    np.testing.assert_array_equal(got, want)
    assert info.keys() == want_info.keys()
    for key in info:
        np.testing.assert_array_equal(info[key], want_info[key])
    assert info["n_registered_pairs"] > 10


def test_pairs_within_warns_when_the_cap_binds_and_returns_the_same_pairs():
    rng = np.random.default_rng(4)
    qa = rng.uniform(0.0, 3.0, (50, 2))
    qb = rng.uniform(0.0, 3.0, (400, 2))           # ~45 points per 1 m cell
    with pytest.warns(UserWarning, match=r"cut \d+ candidate pairs"):
        got = alignment._pairs_within(qa, qb, 1.0, max_pairs_per_a=8)
    want = jax_alignment._pairs_within(qa, qb, 1.0, max_pairs_per_a=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with warnings.catch_warnings():
        warnings.simplefilter("error")             # an unbound cap stays silent
        got = alignment._pairs_within(qa, qb, 1.0, max_pairs_per_a=512)
    for g, w in zip(got, jax_alignment._pairs_within(qa, qb, 1.0, max_pairs_per_a=512)):
        np.testing.assert_array_equal(g, w)


def test_pose_graph_interop_round_trip():
    noisy, obs, _ = drifted_world(seed=3, drift=0.3)
    gj = jax_builder.build_pose_graph(noisy, obs, max_landmarks=16, max_factors=256)
    got = pose_graph_from_numpy({k: np.asarray(v) for k, v in gj._asdict().items()}, "cpu")
    assert_same_graph(got, gj)
    back = pose_graph_to_numpy(got)
    assert back.keys() == gj._asdict().keys()
    with pytest.raises(KeyError, match="obs_kf"):
        pose_graph_from_numpy({k: v for k, v in back.items() if k != "obs_kf"}, "cpu")
