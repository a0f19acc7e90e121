"""The reference-compatible facades of ``fastslam_tpu_torch.api`` against
``fastslam_tpu.api``, on the CPU.

``GeometryUtils``, ``LineFilter``, ``HoughTransformation``, ``ICP`` and
``LandmarkUtils`` are held to the JAX facades within the tolerances of the
frontend and ICP parity tests (line bins exact in parity mode, points at
1e-4, ICP rotation and translation at 1e-5).  ``FastSLAM2.iterate`` is held
to the port's own ``fastslam_step``, which the blocks-engine tests hold to
JAX: the draws of torch's Philox and JAX's threefry cannot match.
"""

import inspect

import numpy as np
import pytest
import torch

from fastslam_tpu import api as jax_api

from fastslam_tpu_torch import api, models
from fastslam_tpu_torch.app.runner import scan_points
from fastslam_tpu_torch.core import cuda_kernels, kernels
from fastslam_tpu_torch.core.state import init_state, pad_measurements
from fastslam_tpu_torch.drivers.replay import record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld

torch.set_num_threads(1)

FACADES = ("FastSLAM2", "LineFilter", "HoughTransformation", "ICP", "GeometryUtils",
           "LandmarkUtils")


@pytest.fixture(scope="module")
def scans():
    pts, valid = scan_points(record_log(SimWorld(seed=3), num_ticks=28))
    return [p[v] for p, v in zip(pts[::9], valid[::9])]


def test_the_facades_and_models_exist_and_default_to_the_card():
    for name in FACADES:
        assert hasattr(api, name) and hasattr(jax_api, name)
    for name in ("Point", "DirectedPoint", "Measurement", "Landmark", "Particle"):
        assert hasattr(models, name)
    defaults = [inspect.signature(f).parameters["device"].default for f in (
        api.FastSLAM2, api.LineFilter.filter, api.HoughTransformation.detect_line_intersections,
        api.ICP.get_transformation, api.GeometryUtils.cluster_points,
        api.LandmarkUtils.get_measurements_to_landmarks)]
    assert defaults == ["cuda"] * 6


def test_geometry_utils_match_jax():
    a, b, cov = np.array([0.3, -0.2]), np.array([1.0, 0.5]), np.array([[0.3, 0.1], [0.1, 0.2]])
    assert api.GeometryUtils.mahalanobis_distance(a, b, cov) == \
        jax_api.GeometryUtils.mahalanobis_distance(a, b, cov)
    assert api.GeometryUtils.calculate_distance_and_angle(1.0, -2.0) == \
        jax_api.GeometryUtils.calculate_distance_and_angle(1.0, -2.0)
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.normal(0, 0.1, (6, 2)), rng.normal(4, 0.1, (5, 2)),
                          [[0.55, 0.0], [9.0, 9.0]]]).astype(np.float32)
    for min_samples in (1, 3, 6):
        got = api.GeometryUtils.cluster_points(pts, 0.5, min_samples, device="cpu")
        want = jax_api.GeometryUtils.cluster_points(pts, 0.5, min_samples)
        assert len(got) == len(want) > 0, min_samples
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("sigma", [0.1, 1.0])
def test_line_filter_matches_jax(scans, sigma):
    got = api.LineFilter.filter(scans[0], sigma, device="cpu")
    np.testing.assert_allclose(got, jax_api.LineFilter.filter(scans[0], sigma), atol=1e-5)


def test_hough_intersections_match_jax(scans):
    for pts in scans:
        got = api.HoughTransformation.detect_line_intersections(pts, device="cpu")
        want = jax_api.HoughTransformation.detect_line_intersections(pts)
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_icp_matches_jax(scans):
    for src, tgt in zip(scans[:-1], scans[1:]):
        launches = cuda_kernels.LAUNCHES["icp_correspondences"]
        got = api.ICP.get_transformation(src, tgt, device="cpu")
        assert cuda_kernels.LAUNCHES["icp_correspondences"] == launches   # the CPU path
        want = jax_api.ICP.get_transformation(src, tgt)
        np.testing.assert_allclose(got[0], want[0], atol=1e-5)
        np.testing.assert_allclose(got[1], want[1], atol=1e-5)


def test_landmark_utils_match_jax(scans):
    pts = scans[1]
    got = api.LandmarkUtils.get_measurements_to_landmarks(pts, device="cpu")
    want = jax_api.LandmarkUtils.get_measurements_to_landmarks(pts)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose([m.as_vector() for m in got], [m.as_vector() for m in want],
                               atol=1e-4)
    lms = [models.Landmark(-3.0, -3.0), models.Landmark(3.0, 0.0)]
    for obs in (models.Landmark(3.1, 0.0), models.Landmark(-5.0, 5.0)):
        g, w = (mod.LandmarkUtils.associate_landmarks(obs, lms) for mod in (api, jax_api))
        assert (g[1], w[1]) in ((1, 1), (None, None)) and g[1] == w[1]


@pytest.mark.parametrize("proposal", ["motion", "fastslam2"])
def test_fastslam2_iterate_is_fastslam_step(proposal):
    cfg = api.FastSLAMConfig(num_particles=24, max_landmarks=8, parity_mode=False,
                             proposal_mode=proposal)
    slam = api.FastSLAM2(cfg, rng=5, device="cpu")
    gen = torch.Generator().manual_seed(5)
    state = init_state(cfg, "cpu")
    ticks = [(0.0, 0.4, [(2.0, 0.3), (3.5, -0.7)]), (0.2, 0.0, [(2.1, 0.1)]),
             (0.0, 0.4, [(1.8, 0.35), (3.2, -0.8), (4.0, 1.0)])]
    for rot, trans, rb in ticks:
        got = slam.iterate(rot, trans, [models.Measurement(d, b) for d, b in rb])
        draws = kernels.draw(gen, 24, fs2=proposal == "fastslam2")
        state, pose = kernels.fastslam_step(state, rot, trans,
                                            pad_measurements(cfg, rb, "cpu"), cfg, draws)
        assert got == tuple(pose.tolist())
    for name, v in state.__dict__.items():
        assert torch.equal(getattr(slam.state, name), v), name
    parts = slam.particles
    assert len(parts) == 24 and len(parts[0].landmarks) == int(state.lm_count[0])
    assert parts[0].landmarks[0].cov.shape == (2, 2)


def test_update_known_landmarks_clusters_the_facade_state():
    cfg = api.FastSLAMConfig(num_particles=16, max_landmarks=8, parity_mode=False)
    slam = api.FastSLAM2(cfg, device="cpu")
    for _ in range(3):
        slam.iterate(0.0, 0.0, [models.Measurement(2.0, 0.3), models.Measurement(3.0, -1.0)])
    api.LandmarkUtils.update_known_landmarks(slam)
    assert len(api.LandmarkUtils.known_landmarks) == 2
    xy = sorted((lm.x, lm.y) for lm in api.LandmarkUtils.known_landmarks)
    np.testing.assert_allclose(xy[0], [3.0 * np.cos(-1.0), 3.0 * np.sin(-1.0)], atol=0.05)
