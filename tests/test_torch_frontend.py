"""The port's perception frontend against ``fastslam_tpu.frontend`` on
recorded synthetic scans.

* The Hough accumulator is exact: an integer histogram of the port's own
  votes, recomputed in numpy, at 4096 rho bins and at 4000 (not a multiple
  of 64).  It is not compared cell by cell with JAX: XLA on the CPU contracts
  ``x cos + y sin`` into a fused multiply-add and rounds a few cos/sin table
  entries differently, so votes whose rho lies within ~1e-4 px of a bin edge
  may land one bin over.
* Line bins (parity mode: no refit) are exact against JAX.
* ``scan_to_measurements`` gives the same valid count and values at 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.frontend.hough import hough_lines as jax_hough_lines
from fastslam_tpu.frontend.pipeline import scan_to_measurements as jax_scan_to_measurements

from fastslam_tpu_torch.app.runner import scan_points
from fastslam_tpu_torch.drivers.replay import record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.frontend import hough
from fastslam_tpu_torch.frontend.clustering import connected_component_clusters
from fastslam_tpu_torch.frontend.line_filter import line_filter
from fastslam_tpu_torch.frontend.pipeline import scan_to_measurements
from fastslam_tpu_torch.interop import config_from_jax_fields

torch.set_num_threads(1)

TICKS = (0, 9, 18, 27, 36, 47)


@pytest.fixture(scope="module")
def scans():
    log = record_log(SimWorld(seed=3), num_ticks=48)
    pts, valid = scan_points(log)
    return pts[list(TICKS)], valid[list(TICKS)]


def numpy_accumulator(points, valid, config, cos_t, sin_t):
    """Independent vote count: unique disc pixels x theta bins -> rho bins."""
    sx = points[:, 0] * np.float32(config.hough_scale)
    sy = points[:, 1] * np.float32(config.hough_scale)
    min_x = int(np.trunc(sx[valid].min()))
    min_y = int(np.trunc(sy[valid].min()))
    off_x = (-min_x if min_x < 0 else 0) + config.hough_padding
    off_y = (-min_y if min_y < 0 else 0) + config.hough_padding
    px = np.trunc(sx[valid]).astype(np.int64) + off_x
    py = np.trunc(sy[valid]).astype(np.int64) + off_y
    r = config.hough_point_radius
    pixels = {(x + dx, y + dy) for x, y in zip(px, py)
              for dx in range(-r, r + 1) for dy in range(-r, r + 1)
              if dx * dx + dy * dy <= r * r}
    ex, ey = np.asarray(sorted(pixels), np.float32).T
    rho = ex[:, None] * cos_t[None, :] + ey[:, None] * sin_t[None, :]
    rho_idx = np.round(rho).astype(np.int64) + config.hough_rho_bins // 2
    t_idx = np.broadcast_to(np.arange(config.hough_num_thetas), rho_idx.shape)
    keep = (rho_idx >= 0) & (rho_idx < config.hough_rho_bins)
    acc = np.zeros((config.hough_num_thetas, config.hough_rho_bins), np.int64)
    np.add.at(acc, (t_idx[keep], rho_idx[keep]), 1)
    return acc


@pytest.mark.parametrize("rho_bins", [4096, 4000])
def test_hough_accumulator_is_an_exact_vote_count(scans, rho_bins):
    cfg = config_from_jax_fields(dataclasses.asdict(JaxConfig(hough_rho_bins=rho_bins)))
    cos_t, sin_t = (x.numpy() for x in hough.theta_table(cfg, "cpu"))
    for pts, valid in zip(*scans):
        acc = hough.hough_accumulator(torch.from_numpy(pts), torch.from_numpy(valid), cfg)[0]
        want = numpy_accumulator(pts, valid, cfg, cos_t, sin_t)
        assert acc.max() >= cfg.hough_threshold      # lines are present
        np.testing.assert_array_equal(acc.numpy().astype(np.int64), want)


@pytest.mark.parametrize("rho_bins", [4096, 4000])
def test_hough_line_bins_match_jax(scans, rho_bins):
    jcfg = JaxConfig(hough_rho_bins=rho_bins, parity_mode=True)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    jax_fn = jax.jit(lambda p, v: jax_hough_lines(p, v, jcfg))
    for pts, valid in zip(*scans):
        want, *want_frame = jax_fn(jnp.asarray(pts), jnp.asarray(valid))
        got, *got_frame = hough.hough_lines(torch.from_numpy(pts), torch.from_numpy(valid), cfg)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        ok = got.valid.numpy()
        assert ok.sum() >= 2
        np.testing.assert_array_equal(got.rho.numpy()[ok], np.asarray(want.rho)[ok])
        np.testing.assert_array_equal(got.theta.numpy()[ok], np.asarray(want.theta)[ok])
        for g, w in zip(got_frame, want_frame):
            assert int(g) == int(w)


@pytest.mark.parametrize("parity", [False, True])
def test_scan_to_measurements_matches_jax(scans, parity):
    jcfg = JaxConfig(parity_mode=parity)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    jax_fn = jax.jit(lambda p, v: jax_scan_to_measurements(p, v, jcfg))
    seen = 0
    for pts, valid in zip(*scans):
        want = jax_fn(jnp.asarray(pts), jnp.asarray(valid))
        got = scan_to_measurements(torch.from_numpy(pts), torch.from_numpy(valid), cfg)
        ok = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), ok)
        np.testing.assert_allclose(got.range_bearing.numpy()[ok],
                                   np.asarray(want.range_bearing)[ok],
                                   rtol=1e-4, atol=1e-4)
        seen += int(ok.sum())
    assert seen >= len(TICKS)   # corners were found


def test_line_filter_and_clustering_match_jax():
    """The general (radius > 0) line filter, and clustering with invalid
    points, whose sentinel labels JAX's gather clamps."""
    from fastslam_tpu.frontend.clustering import (
        connected_component_clusters as jax_clusters,
    )
    from fastslam_tpu.frontend.line_filter import line_filter as jax_line_filter

    rng = np.random.default_rng(0)
    pts = rng.normal(0, 2, (64, 2)).astype(np.float32)
    jcfg = JaxConfig(line_filter_sigma=1.5)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    np.testing.assert_allclose(line_filter(torch.from_numpy(pts), cfg).numpy(),
                               np.asarray(jax_line_filter(jnp.asarray(pts), jcfg)),
                               rtol=1e-6, atol=1e-6)

    valid = rng.random(64) > 0.3
    want = jax_clusters(jnp.asarray(pts), jnp.asarray(valid), 0.8)
    got = connected_component_clusters(torch.from_numpy(pts), torch.from_numpy(valid), 0.8)
    np.testing.assert_array_equal(got.label.numpy(), np.asarray(want.label))
    np.testing.assert_array_equal(got.is_rep.numpy(), np.asarray(want.is_rep))
    np.testing.assert_allclose(got.centroid.numpy(), np.asarray(want.centroid),
                               rtol=1e-6, atol=1e-6)
