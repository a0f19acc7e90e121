"""The blocks step ``fastslam_step`` and the chunked step
``fastslam_steps_planes_chunked`` with the resample decided on the device
(``on_device=True``) or on the host: the same state bit for bit, on a tick
that resamples and on one that does not; and the device form against JAX's
steps given JAX's own draws, at the bars of ``tests/test_torch_step.py``
and ``tests/test_torch_blocks.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.core import kernels as jax_kernels
from fastslam_tpu.core.state import Measurements as JaxMeasurements

from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import Measurements
from fastslam_tpu_torch.interop import (
    config_from_jax_fields, filter_state_from_numpy, planes_state_from_numpy,
)
from tests.test_torch_blocks import (
    STEP_CASES, assert_blocks_match, blocks_of, fs2_inputs, jax_config,
    jax_draws as jax_blocks_draws, jax_filter_state, measurements, port_config,
)
from tests.test_torch_fused_multi import chunk_inputs
from tests.test_torch_fused_update import base_config, seeded_planes
from tests.test_torch_step import (
    assert_away_from_grid, assert_states_match, jax_draws, jax_state,
)

torch.set_num_threads(1)


def assert_same(a, b):
    """Every field of two port states equal bit for bit."""
    for k, v in vars(a).items():
        w = getattr(b, k)
        assert (v is None) == (w is None), k
        if v is not None:
            assert v.dtype == w.dtype and torch.equal(v, w), k


def resampled(state, p):
    """Whether a production step resampled: its weights are uniform."""
    return bool(torch.all(state.log_weights == torch.full((p,), -float(np.log(p)))))


def blocks_inputs(case, p=128, l=16, m=8):
    kw = dict(STEP_CASES[case])
    parity, _ = kw.pop("parity"), kw.pop("key")
    floors, dial = kw.pop("floors", None), kw.pop("dial", None)
    jcfg = jax_config(parity, p, l, m, **kw)
    cfg = port_config(jcfg)
    if kernels.uses_fs2(cfg):
        st, z, z_valid, _ = fs2_inputs(p, l, m, seed=11)
    else:
        st = blocks_of(seeded_planes(p, l, seed=11, fill=6, parity=parity))
        z, z_valid = measurements(m, seed=12)
    st["log_weights"] = np.random.default_rng(13).normal(-3, 2.5, p).astype(np.float32)
    extra = {}
    if floors is not None:
        extra = {"proposal_floors": tuple(torch.tensor(f) for f in floors),
                 "evidence_scale": torch.tensor(dial)}
    return jcfg, cfg, st, Measurements(torch.from_numpy(z), torch.from_numpy(z_valid)), extra


@pytest.mark.parametrize("threshold", [0.5, 0.0], ids=["resamples", "no-resample"])
@pytest.mark.parametrize("case", list(STEP_CASES) + ["fs2 evidence"])
def test_blocks_step_on_device_equals_host(case, threshold):
    """Two ticks of ``fastslam_step`` each way from the same state and draws;
    the wide weight spread makes a tick resample at threshold 0.5."""
    if case == "fs2 evidence":
        jcfg, cfg, st, ms, extra = blocks_inputs("fs2")
        cfg = cfg.replace(fs2_evidence_weights=True)
    else:
        jcfg, cfg, st, ms, extra = blocks_inputs(case)
    cfg = cfg.replace(resample_threshold_frac=threshold)
    p = cfg.num_particles
    fs2 = kernels.uses_fs2(cfg)
    gen = torch.Generator().manual_seed(5)
    host = dev = quiet = filter_state_from_numpy(st, "cpu")
    never = cfg.replace(resample_threshold_frac=0.0)
    for _ in range(2):
        draws = kernels.draw(gen, p, fs2=fs2)
        host, pose_h = kernels.fastslam_step(host, 0.0, 0.02, ms, cfg, draws, **extra)
        dev, pose_d = kernels.fastslam_step(dev, 0.0, 0.02, ms, cfg, draws, on_device=True,
                                            **extra)
        assert_same(host, dev)
        assert torch.equal(pose_h, pose_d)
        quiet, _ = kernels.fastslam_step(quiet, 0.0, 0.02, ms, never, draws, **extra)
    # whether a tick resampled: against the same ticks that never do
    assert torch.equal(quiet.poses, dev.poses) == (threshold == 0.0)


def chunk_case(fs2, p=256, l=16, m=8, c=4):
    jcfg = base_config(False, p, l, m)
    if fs2:
        jcfg = jcfg.replace(proposal_mode="fastslam2")
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    st = seeded_planes(p, l, seed=31, fill=6, parity=False)
    st["log_weights"] = np.random.default_rng(32).normal(-3, 2.5, p).astype(np.float32)
    z, z_valid, _, _ = chunk_inputs(c, m, p, seed=33)
    rots = np.array([0.0, 0.3, 0.0, -0.2], np.float32)
    trans = np.array([0.4, 0.0, 0.35, 0.0], np.float32)
    return jcfg, cfg, st, z, z_valid, rots, trans


@pytest.mark.parametrize("threshold", [0.5, 0.0], ids=["resamples", "no-resample"])
@pytest.mark.parametrize("fs2", [False, True], ids=["motion", "fs2"])
def test_chunked_step_on_device_equals_host(fs2, threshold):
    """Two chunks of C=4 ticks each way from the same state and draws."""
    _, cfg, st, z, z_valid, rots, trans = chunk_case(fs2)
    cfg = cfg.replace(resample_threshold_frac=threshold)
    p, c = cfg.num_particles, rots.shape[0]
    ms = Measurements(torch.from_numpy(z), torch.from_numpy(z_valid))
    gen = torch.Generator().manual_seed(7)
    host = planes_state_from_numpy(st, "cpu")
    dev = host.clone()
    uniform = []
    for _ in range(2):
        draws = kernels.draw(gen, p, c, fs2=fs2)
        host, est_h = kernels.fastslam_steps_planes_chunked(
            host, torch.from_numpy(rots), torch.from_numpy(trans), ms, cfg, draws)
        dev, est_d = kernels.fastslam_steps_planes_chunked(
            dev, torch.from_numpy(rots), torch.from_numpy(trans), ms, cfg, draws,
            on_device=True)
        assert_same(host, dev)
        assert torch.equal(est_h, est_d)
        uniform.append(resampled(dev, p))
    assert uniform[0] == (threshold > 0)


@pytest.mark.parametrize("threshold", [0.5, 0.0], ids=["resamples", "no-resample"])
@pytest.mark.parametrize("parity", [False, True], ids=["production", "parity"])
def test_planes_step_on_device_equals_host(parity, threshold):
    """Two ticks of ``fastslam_step_planes`` each way from the same state and
    draws: the device form, whose resample is the staircase and the in-place
    gather of ``cuda_kernels`` (their plain versions here), against the
    host-decided one; the device form returns the caller's own planes and
    counts, resampled or not."""
    p, l, m = 256, 16, 8
    cfg = config_from_jax_fields(dataclasses.asdict(base_config(parity, p, l, m)))
    cfg = cfg.replace(resample_threshold_frac=threshold)
    st = seeded_planes(p, l, seed=41, fill=6, parity=parity)
    st["log_weights"] = np.random.default_rng(42).normal(-3, 2.5, p).astype(np.float32)
    z, z_valid = measurements(m, seed=43)
    ms = Measurements(torch.from_numpy(z), torch.from_numpy(z_valid))
    gen = torch.Generator().manual_seed(9)
    host = planes_state_from_numpy(st, "cpu")
    dev, quiet = host.clone(), host.clone()
    never = cfg.replace(resample_threshold_frac=0.0)
    own = lambda s: [s.lm_mx, s.lm_my, s.lm_ca, s.lm_cb, s.lm_cc, s.lm_cd, s.lm_count]
    for _ in range(2):
        draws = kernels.draw(gen, p)
        host, pose_h = kernels.fastslam_step_planes(host, 0.0, 0.4, ms, cfg, draws)
        mine = own(dev)
        dev, pose_d = kernels.fastslam_step_planes(dev, 0.0, 0.4, ms, cfg, draws,
                                                   on_device=True)
        assert all(a is b for a, b in zip(own(dev), mine))
        assert_same(host, dev)
        assert torch.equal(pose_h, pose_d)
        quiet, _ = kernels.fastslam_step_planes(quiet, 0.0, 0.4, ms, never, draws)
    # whether a tick resampled: against the same ticks that never do
    assert torch.equal(quiet.poses, dev.poses) == (threshold == 0.0)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_blocks_step_on_device_matches_jax(case):
    """Two ticks of the device form against JAX's ``fastslam_step`` with
    JAX's draws; the spread makes at least one resample."""
    jcfg, cfg, st, ms, extra = blocks_inputs(case)
    fs2 = kernels.uses_fs2(cfg)
    jkw = {}
    if extra:
        jkw = {"proposal_floors": tuple(jnp.float32(float(f)) for f in extra["proposal_floors"]),
               "evidence_scale": jnp.float32(float(extra["evidence_scale"]))}
    jms = JaxMeasurements(jnp.asarray(ms.range_bearing.numpy()), jnp.asarray(ms.valid.numpy()))
    js = jax_filter_state(st, seed=STEP_CASES[case]["key"])
    state = filter_state_from_numpy(st, "cpu")
    resampled_ticks = 0
    for _ in range(2):
        draws = jax_blocks_draws(js, fs2)
        pre, _ = jax_kernels.fastslam_step(js, jnp.float32(0.0), jnp.float32(0.02), jms,
                                           jcfg.replace(resample_threshold_frac=0.0), **jkw)
        js, want_pose = jax_kernels.fastslam_step(js, jnp.float32(0.0), jnp.float32(0.02),
                                                  jms, jcfg, **jkw)
        if not np.array_equal(np.asarray(pre.log_weights), np.asarray(js.log_weights)):
            assert_away_from_grid(pre.log_weights, draws.u0)
            resampled_ticks += 1
        state, pose = kernels.fastslam_step(state, 0.0, 0.02, ms, cfg, draws, on_device=True,
                                            **extra)
        tol = 1e-4 if fs2 else 1e-5
        assert_blocks_match(state, js, tol=tol)
        np.testing.assert_allclose(pose.numpy(), np.asarray(want_pose), rtol=tol, atol=tol)
    assert resampled_ticks >= 1


@pytest.mark.parametrize("threshold", [0.5, 0.0], ids=["resamples", "no-resample"])
def test_chunked_step_on_device_matches_jax(threshold):
    """One chunk of C=4 ticks, the device form against JAX's
    ``fastslam_steps_planes_chunked`` with JAX's draws."""
    jcfg, cfg, st, z, z_valid, rots, trans = chunk_case(False)
    jcfg = jcfg.replace(resample_threshold_frac=threshold)
    cfg = cfg.replace(resample_threshold_frac=threshold)
    p, c = cfg.num_particles, rots.shape[0]
    js = jax_state(st, seed=34)
    draws = jax_draws(js, (c, p))
    jms = JaxMeasurements(jnp.asarray(z), jnp.asarray(z_valid))
    want_state, want_est = jax_kernels.fastslam_steps_planes_chunked(
        js, jnp.asarray(rots), jnp.asarray(trans), jms, jcfg)
    state, est = kernels.fastslam_steps_planes_chunked(
        planes_state_from_numpy(st, "cpu"), torch.from_numpy(rots), torch.from_numpy(trans),
        Measurements(torch.from_numpy(z), torch.from_numpy(z_valid)), cfg, draws,
        on_device=True)
    if threshold:
        pre, _ = jax_kernels.fastslam_steps_planes_chunked(
            jax_state(st, seed=34), jnp.asarray(rots), jnp.asarray(trans), jms,
            jcfg.replace(resample_threshold_frac=0.0))
        assert_away_from_grid(pre.log_weights, draws.u0)
        assert np.allclose(np.asarray(want_state.log_weights), -np.log(p))   # resampled
    else:
        assert not np.allclose(np.asarray(want_state.log_weights), -np.log(p))
    np.testing.assert_allclose(est.numpy(), np.asarray(want_est), rtol=1e-4, atol=1e-4)
    assert_states_match(state, want_state, tol=1e-4)
