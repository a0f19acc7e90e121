"""The port's filter core against ``fastslam_tpu.core.kernels``: motion model,
weights, Neff at 1e-6; the staircase resample bit-identical on the same
cumulative weights; the planes resample gather exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.core import kernels as jax_kernels
from fastslam_tpu.core.state import PlanesState as JaxPlanesState

from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.interop import (
    config_from_jax_fields, planes_state_from_numpy, planes_state_to_numpy,
)
from tests.test_torch_fused_update import seeded_planes

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a))


def test_wrap_angle_matches_jax_on_negative_angles():
    x = np.random.default_rng(0).uniform(-20.0, 20.0, 4096).astype(np.float32)
    x[:4] = [-np.pi, np.pi, -3 * np.pi, -1e-7]
    got = kernels.wrap_angle(t(x)).numpy()
    want = np.asarray(jax_kernels.wrap_angle(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got >= -np.pi).all() and (got < np.pi + 1e-6).all()


@pytest.mark.parametrize("rotation,translation", [(0.0, 0.4), (0.3, 0.0), (-0.5, 0.2)])
def test_propagate_particles_matches_jax(rotation, translation):
    rng = np.random.default_rng(1)
    p = 256
    poses = rng.normal(0, 1, (p, 3)).astype(np.float32)
    poses[:, 2] = rng.uniform(-np.pi, np.pi, p)
    rn = (0.01 * rng.normal(size=p)).astype(np.float32)
    tn = (0.02 * rng.normal(size=p)).astype(np.float32)
    want = jax_kernels.propagate_particles(
        jnp.asarray(poses), jnp.float32(rotation), jnp.float32(translation),
        jnp.asarray(rn), jnp.asarray(tn))
    got = kernels.propagate_particles(t(poses), rotation, translation, t(rn), t(tn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("mean,scale", [(-5.0, 0.5), (-5.0, 4.0), (-20.0, 1.0)])
def test_weights_and_neff_match_jax(parity, mean, scale):
    """Normalization in both modes and Neff.  The wide spread drives parity's
    below-floor branch, the low mean its reset to uniform.  Log-weights stay
    above -87, where float32 exp() turns denormal: XLA on the CPU flushes
    denormals to zero and torch does not."""
    jcfg = JaxConfig(parity_mode=parity)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    logw = np.random.default_rng(2).normal(mean, scale, 256).astype(np.float32)
    assert logw.min() > -80.0
    want = jax_kernels.normalize_log_weights(jnp.asarray(logw), jcfg)
    got = kernels.normalize_log_weights(t(logw), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        kernels.effective_particles(got, cfg).item(),
        float(jax_kernels.effective_particles(want, jcfg)), rtol=1e-6)


def staircase_cases(rng, n):
    dirichlet = rng.dirichlet(np.full(n, 0.5))
    zero_runs = np.zeros(n)
    zero_runs[rng.integers(0, n, max(2, n // 8))] = rng.uniform(0.5, 1.0, max(2, n // 8))
    degenerate = np.full(n, 1e-12)
    degenerate[rng.integers(n)] = 1.0
    return {
        "dirichlet": dirichlet,
        "zero_weight_runs": zero_runs / zero_runs.sum(),
        "degenerate": degenerate / degenerate.sum(),
        "undersum_tail": dirichlet * 0.97,
        "grid_ties": np.full(n, 1.0 / n),
    }


@pytest.mark.parametrize("n", [8, 100, 1024])
def test_grid_staircase_bit_identical_on_same_cum(n):
    """Both staircases get the SAME cumulative weights (XLA's and torch's
    cumsum may round differently), so the indices must be identical."""
    rng = np.random.default_rng(n)
    for name, w in staircase_cases(rng, n).items():
        cum = np.cumsum(w.astype(np.float32), dtype=np.float32)
        for u0 in (0.0, 1e-7, 0.3 / n, (n - 1) / (n * n)):
            want = np.asarray(jax_kernels.grid_staircase_indices(
                jnp.asarray(cum), jnp.float32(u0), n))
            got = kernels.grid_staircase_indices(t(cum), torch.tensor(u0, dtype=torch.float32), n)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} u0={u0}")


@pytest.mark.parametrize("parity", [False, True])
def test_resample_planes_state_matches_jax(parity):
    p, l = 128, 8
    jcfg = JaxConfig(num_particles=p, max_landmarks=l, parity_mode=parity)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    st = seeded_planes(p, l, seed=4, fill=6, parity=parity)
    idx = np.random.default_rng(5).integers(0, p, p).astype(np.int32)
    js = JaxPlanesState(**{k: None if v is None else jnp.asarray(v) for k, v in st.items()},
                        rng=jax.random.key(0))
    want = jax_kernels.resample_planes_state(js, jnp.asarray(idx), jcfg)
    got = planes_state_to_numpy(kernels.resample_planes_state(
        planes_state_from_numpy(st, "cpu"), t(idx), cfg))
    for k, v in got.items():
        w = getattr(want, k)
        if w is None:
            assert v is None
        else:
            np.testing.assert_array_equal(v, np.asarray(w), err_msg=k)


def test_draws_come_from_the_generator():
    """Draws are reproducible from the generator's seed and shaped per mode."""
    a = kernels.draw(torch.Generator().manual_seed(7), 64, 4)
    b = kernels.draw(torch.Generator().manual_seed(7), 64, 4)
    assert a.rot.shape == (4, 64) and a.trans.shape == (4, 64)
    assert torch.equal(a.rot, b.rot) and torch.equal(a.u0, b.u0)
    assert 0.0 <= a.u0.item() < 1.0 / 64
    assert kernels.draw(torch.Generator().manual_seed(7), 64).rot.shape == (64,)
