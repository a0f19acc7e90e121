"""The port's FastSLAM 2.0 steps against the JAX steps (Pallas interpret
mode), with JAX's own draws replayed into the port.

Per call, ``jax.random.split(state.rng, 4)`` gives ``k_rot`` (the fs2 pose
noise: ``(P, 3)`` per tick, ``(C, 3, P)`` per chunk) and ``k_u`` (the
resample offset), as the JAX step draws them.  A sequence of three chunks
and two tail ticks runs from one start state on both sides; each call's
state and estimates agree at 1e-4, counts exactly.  Each call first checks
that, where it resamples, no cumulative weight lies within 1e-5 of a
resample grid position, as ``tests/test_torch_step.py`` does.
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
from fastslam_tpu_torch.interop import config_from_jax_fields, planes_state_from_numpy
from tests.test_torch_fused_fs2 import fs2_config, mapped_state
from tests.test_torch_fused_fs2_multi import chunk_inputs
from tests.test_torch_fused_update import base_config, seeded_planes
from tests.test_torch_step import FIELDS, assert_away_from_grid, assert_states_match

torch.set_num_threads(1)


def jax_state(st, rng):
    return JaxPlanesState(
        **{k: None if st.get(k) is None else jnp.asarray(st[k]) for k in FIELDS},
        rng=rng)


def fs2_draws(js, shape):
    """The draws the JAX fs2 step makes from its state's key."""
    _, k_rot, _, k_u = jax.random.split(js.rng, 4)
    p = js.num_particles
    return kernels.Draws(
        rot=None, trans=None,
        u0=torch.tensor(float(jax.random.uniform(k_u, (), jnp.float32, maxval=1.0 / p))),
        noise=torch.tensor(np.asarray(jax.random.normal(k_rot, shape, jnp.float32))),
    )


def check_resample_margin(step, state, cfg, u0):
    """Runs the port's step with resampling off on a copy of the state; if
    its weights make the step resample, they must lie away from the grid.
    Returns whether the step resamples."""
    out, _ = step(state.clone(), cfg.replace(resample_threshold_frac=0.0))
    log_w = out.log_weights
    resamples = bool(kernels.effective_particles(log_w, cfg)
                     < cfg.resample_threshold_frac * log_w.shape[0])
    if resamples:
        assert_away_from_grid(log_w.numpy(), u0)
    return resamples


# the keys put every resample of the sequence clear of the grid
@pytest.mark.parametrize("evidence,key", [(False, 63), (True, 66)])
def test_fs2_step_sequence_matches_jax(evidence, key):
    """Three chunks of 4 (one with [C] floors and mode dial), then two
    per-tick steps (one with scalar floors and dial); at least one resample."""
    p, l, m, c = 128, 16, 8, 4
    jcfg = fs2_config(p, l, m, evidence)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    st, world = mapped_state(p, l, seed=61, fill=10)
    z, z_valid, rots, trans, _ = chunk_inputs(3 * c + 2, m, p, world, seed=62)
    js = jax_state(st, jax.random.key(key))
    state = planes_state_from_numpy(st, "cpu")
    resampled = 0

    for call in range(5):
        chunk = call < 3
        sl = slice(call * c, (call + 1) * c) if chunk else 3 * c + call - 3
        ms = Measurements(torch.from_numpy(z[sl]), torch.from_numpy(z_valid[sl]))
        jms = JaxMeasurements(jnp.asarray(z[sl]), jnp.asarray(z_valid[sl]))
        kw, jkw = {}, {}
        if call == 1:      # per-tick [C] floors and dial
            floors = (np.array([0.004, 0.01, 0.006, 0.005], np.float32),
                      np.array([0.004, 0.003, 0.005, 0.002], np.float32))
            dial = np.array([1.0, 0.37, 0.0, 0.37], np.float32)
        elif call == 4:    # scalar floors and dial
            floors, dial = (np.float32(0.008), np.float32(0.003)), np.float32(0.37)
        else:
            floors = dial = None
        if floors is not None:
            kw = {"proposal_floors": tuple(torch.tensor(f) for f in floors),
                  "evidence_scale": torch.tensor(dial)}
            jkw = {"proposal_floors": tuple(jnp.asarray(f) for f in floors),
                   "evidence_scale": jnp.asarray(dial)}
        if chunk:
            draws = fs2_draws(js, (c, 3, p))
            jstep = jax_kernels.fastslam_steps_planes_chunked
            step = lambda s, cf: kernels.fastslam_steps_planes_chunked(
                s, torch.from_numpy(rots[sl]), torch.from_numpy(trans[sl]), ms, cf,
                draws, **kw)
            jargs = (jnp.asarray(rots[sl]), jnp.asarray(trans[sl]))
        else:
            draws = fs2_draws(js, (p, 3))
            jstep = jax_kernels.fastslam_step_planes
            step = lambda s, cf: kernels.fastslam_step_planes(
                s, float(rots[sl]), float(trans[sl]), ms, cf, draws, **kw)
            jargs = (jnp.float32(rots[sl]), jnp.float32(trans[sl]))

        resampled += check_resample_margin(step, state, cfg, draws.u0)
        js, want_est = jstep(js, *jargs, jms, jcfg, **jkw)
        state, est = step(state, cfg)
        assert_states_match(state, js, tol=1e-4)
        np.testing.assert_allclose(est.numpy(), np.asarray(want_est), rtol=1e-4,
                                   atol=1e-4, err_msg=f"estimate, call {call}")
    assert resampled >= 1


def test_fs2_in_parity_mode_takes_the_motion_branch():
    """Parity mode with proposal_mode='fastslam2' runs the motion proposal,
    as the JAX step does."""
    p, l, m = 256, 16, 8
    jcfg = dataclasses.replace(base_config(True, p, l, m), proposal_mode="fastslam2")
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    st = seeded_planes(p, l, seed=71, fill=6, parity=True)
    rng = np.random.default_rng(72)
    z = np.stack([rng.uniform(0.5, 5.0, m), rng.uniform(-3.0, 3.0, m)], -1).astype(np.float32)
    z_valid = np.arange(m) < 6
    js = jax_state(st, jax.random.key(73))
    _, k_rot, k_trans, k_u = jax.random.split(js.rng, 4)
    draws = kernels.Draws(
        rot=torch.tensor(np.asarray(jax.random.normal(k_rot, (p,), jnp.float32))),
        trans=torch.tensor(np.asarray(jax.random.normal(k_trans, (p,), jnp.float32))),
        u0=torch.tensor(float(jax.random.uniform(k_u, (), jnp.float32, maxval=1.0 / p))),
    )
    ms = Measurements(torch.from_numpy(z), torch.from_numpy(z_valid))
    step = lambda s, cf: kernels.fastslam_step_planes(s, 0.0, 0.4, ms, cf, draws)

    check_resample_margin(step, planes_state_from_numpy(st, "cpu"), cfg, draws.u0)
    want_state, want_pose = jax_kernels.fastslam_step_planes(
        js, jnp.float32(0.0), jnp.float32(0.4),
        JaxMeasurements(jnp.asarray(z), jnp.asarray(z_valid)), jcfg)
    state, pose = step(planes_state_from_numpy(st, "cpu"), cfg)
    assert_states_match(state, want_state)
    np.testing.assert_allclose(pose.numpy(), np.asarray(want_pose), rtol=1e-5, atol=1e-5)
    # bit for bit the port's motion-proposal step
    motion, _ = step(planes_state_from_numpy(st, "cpu"), cfg.replace(proposal_mode="motion"))
    for k in FIELDS:
        a, b = getattr(state, k), getattr(motion, k)
        assert (a is None and b is None) or torch.equal(a, b), k
