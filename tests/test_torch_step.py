"""The port's full filter steps against the JAX steps (Pallas interpret mode).

The torch step takes its random draws as tensors; the test replays JAX's own
draws (``jax.random.split(state.rng, 4)``) into it.  XLA's and torch's
``cumsum`` may round differently, so each case first checks that no
cumulative weight lies within 1e-5 of a resample grid position; there the
resample indices must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.core import kernels as jax_kernels
from fastslam_tpu.core.state import Measurements as JaxMeasurements
from fastslam_tpu.core.state import PlanesState as JaxPlanesState

from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import Measurements
from fastslam_tpu_torch.interop import (
    config_from_jax_fields, planes_state_from_numpy, planes_state_to_numpy,
)
from tests.test_torch_fused_multi import chunk_inputs
from tests.test_torch_fused_update import base_config, seeded_planes

torch.set_num_threads(1)

FIELDS = ("poses", "log_weights", "lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cc",
          "lm_cd", "lm_count")


def jax_state(st, seed):
    return JaxPlanesState(
        **{k: None if st[k] is None else jnp.asarray(st[k]) for k in FIELDS},
        rng=jax.random.key(seed),
    )


def jax_draws(js, shape):
    """The draws the JAX step makes from its state's key."""
    _, k_rot, k_trans, k_u = jax.random.split(js.rng, 4)
    p = js.num_particles
    return kernels.Draws(
        rot=torch.tensor(np.asarray(jax.random.normal(k_rot, shape, jnp.float32))),
        trans=torch.tensor(np.asarray(jax.random.normal(k_trans, shape, jnp.float32))),
        u0=torch.tensor(float(jax.random.uniform(k_u, (), jnp.float32, maxval=1.0 / p))),
    )


def assert_away_from_grid(log_weights, u0):
    w = np.exp(np.asarray(log_weights, np.float64))
    n = w.shape[0]
    cum = np.cumsum(w)
    grid = float(u0) + np.arange(n) / n
    gap = np.min(np.abs(cum[:, None] - grid[None, :]))
    assert gap > 1e-5, f"test data sits on a resample run boundary ({gap:.1e})"


def assert_states_match(got_state, want_state, tol=1e-5):
    got = planes_state_to_numpy(got_state)
    for k in FIELDS:
        w = getattr(want_state, k)
        if w is None:
            assert got[k] is None, k
        elif k == "lm_count":
            np.testing.assert_array_equal(got[k], np.asarray(w))
        else:
            np.testing.assert_allclose(got[k], np.asarray(w), rtol=tol, atol=tol,
                                       err_msg=k)


@pytest.mark.parametrize("parity,spread", [(False, 0.5), (False, 2.5), (True, 2.5)])
def test_step_planes_matches_jax(parity, spread):
    """One tick: propagate, update, normalize, Neff, resample, estimate."""
    p, l, m = 256, 16, 8
    jcfg = base_config(parity, p, l, m)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    st = seeded_planes(p, l, seed=21, fill=6, parity=parity)
    st["log_weights"] = np.random.default_rng(22).normal(-3, spread, p).astype(np.float32)
    rng = np.random.default_rng(23)
    z = np.stack([rng.uniform(0.5, 5.0, m), rng.uniform(-3.0, 3.0, m)], -1).astype(np.float32)
    z_valid = np.arange(m) < 6

    js = jax_state(st, seed=24)
    draws = jax_draws(js, (p,))
    want_state, want_pose = jax_kernels.fastslam_step_planes(
        js, jnp.float32(0.0), jnp.float32(0.4),
        JaxMeasurements(jnp.asarray(z), jnp.asarray(z_valid)), jcfg,
    )
    state, pose = kernels.fastslam_step_planes(
        planes_state_from_numpy(st, "cpu"), 0.0, 0.4,
        Measurements(torch.from_numpy(z), torch.from_numpy(z_valid)), cfg, draws,
    )

    # the weights the resample saw: the same JAX step with resampling off
    pre, _ = jax_kernels.fastslam_step_planes(
        jax_state(st, seed=24), jnp.float32(0.0), jnp.float32(0.4),
        JaxMeasurements(jnp.asarray(z), jnp.asarray(z_valid)),
        jcfg.replace(resample_threshold_frac=0.0),
    )
    assert_away_from_grid(pre.log_weights, draws.u0)
    assert_states_match(state, want_state)
    np.testing.assert_allclose(pose.numpy(), np.asarray(want_pose), rtol=1e-5, atol=1e-5)
    if spread > 1.0 and not parity:
        # the wide weight spread makes Neff fall under the threshold
        assert np.allclose(np.asarray(want_state.log_weights), -np.log(p))


def test_chunked_step_matches_jax():
    """C=4 ticks in one chunked call, then the boundary resample."""
    p, l, m, c = 256, 16, 8, 4
    jcfg = base_config(False, p, l, m)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    st = seeded_planes(p, l, seed=31, fill=6, parity=False)
    st["log_weights"] = np.random.default_rng(32).normal(-3, 2.5, p).astype(np.float32)
    z, z_valid, _, _ = chunk_inputs(c, m, p, seed=33)
    rots = np.array([0.0, 0.3, 0.0, -0.2], np.float32)
    trans = np.array([0.4, 0.0, 0.35, 0.0], np.float32)

    js = jax_state(st, seed=34)
    draws = jax_draws(js, (c, p))
    want_state, want_est = jax_kernels.fastslam_steps_planes_chunked(
        js, jnp.asarray(rots), jnp.asarray(trans),
        JaxMeasurements(jnp.asarray(z), jnp.asarray(z_valid)), jcfg,
    )
    state, est = kernels.fastslam_steps_planes_chunked(
        planes_state_from_numpy(st, "cpu"), torch.from_numpy(rots),
        torch.from_numpy(trans),
        Measurements(torch.from_numpy(z), torch.from_numpy(z_valid)), cfg, draws,
    )
    pre, _ = jax_kernels.fastslam_steps_planes_chunked(
        jax_state(st, seed=34), jnp.asarray(rots), jnp.asarray(trans),
        JaxMeasurements(jnp.asarray(z), jnp.asarray(z_valid)),
        jcfg.replace(resample_threshold_frac=0.0),
    )
    assert_away_from_grid(pre.log_weights, draws.u0)
    np.testing.assert_allclose(est.numpy(), np.asarray(want_est), rtol=1e-4, atol=1e-4)
    assert np.allclose(np.asarray(want_state.log_weights), -np.log(p))  # resampled
    assert_states_match(state, want_state, tol=1e-4)
    with pytest.raises(NotImplementedError):
        kernels.fastslam_steps_planes_chunked(
            planes_state_from_numpy(st, "cpu"), torch.from_numpy(rots),
            torch.from_numpy(trans),
            Measurements(torch.from_numpy(z), torch.from_numpy(z_valid)),
            cfg.replace(parity_mode=True), draws,
        )
