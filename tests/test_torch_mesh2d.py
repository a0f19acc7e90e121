"""The port's 2-D particle x map mesh against the JAX package's, and against
the port's S = 1 and single-device steps bit for bit.

Mirrors ``tests/test_sharded.py:89-111``: P = 16, L = 16, M = 4, the two
measurements, rotation 0 and translation 0.4 on a 4 x 2 mesh (of ``"cpu"``
here, of JAX's 8 virtual CPU devices there).  Each port step takes the draws
the JAX step makes from its state's key (``jax.random.split(state.rng,
4)``).  Against JAX: poses, weights and ``lm_mean`` within 1e-5 (the fs2
proposal at its bar, 1e-4), ``lm_count`` exactly.  Against the port's own
S = 1 and single-device steps: every field and every estimate equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.core.state import init_state as jax_init_state
from fastslam_tpu.core.state import pad_measurements as jax_pad_measurements
from fastslam_tpu.parallel import mesh as jax_mesh
from fastslam_tpu.parallel import sharded as jax_sharded

from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import init_state, pad_measurements
from fastslam_tpu_torch.interop import config_from_jax_fields
from fastslam_tpu_torch.parallel.mesh import (
    make_mesh, planes_state_sharding, shard_state, state_sharding, unshard,
)
from fastslam_tpu_torch.parallel.resample import halo_systematic_resample
from fastslam_tpu_torch.parallel.ring_resample import _ppermute_exchange, ring_halo_resample
from fastslam_tpu_torch.parallel.sharded import make_sharded_step
from tests.test_torch_sharded import jax_draws

torch.set_num_threads(1)

MS = [(2.0, 0.3), (3.5, -0.7)]
FIELDS = ("poses", "log_weights", "lm_mean", "lm_cov", "lm_count")
CASES = {
    "motion parity": {},
    "motion production": dict(parity_mode=False),
    "fs2": dict(parity_mode=False, proposal_mode="fastslam2"),
}


def jax_config(**kw):
    return JaxConfig(**{"num_particles": 16, "max_landmarks": 16, "max_measurements": 4,
                        **kw})


def port(jcfg):
    return config_from_jax_fields(dataclasses.asdict(jcfg))


def assert_equal_states(got, want, tag):
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), (tag, k)


@pytest.fixture(scope="module")
def jax_mesh2d():
    assert len(jax.devices()) == 8, "conftest should provide 8 virtual devices"
    mesh = jax_mesh.make_mesh(jax_config(), map_parallelism=2)
    assert mesh.shape == {"particles": 4, "map": 2}
    return mesh


def test_state_shards_over_particles_and_map():
    """Shard (p, m) holds particles p and landmark slots m L/Sm..(m+1) L/Sm,
    each its own contiguous tensor; a row's shards share its poses, weights
    and counts; ``unshard`` puts it back; L % Sm is checked."""
    cfg = port(jax_config(max_landmarks=8))
    mesh = make_mesh(cfg, ["cpu"] * 8, map_parallelism=2)
    assert (mesh.shape, mesh.particle_shards, mesh.num_shards) == (
        {"particles": 4, "map": 2}, 4, 8)
    placements = state_sharding(mesh, 16, 8)
    assert [(p.particles, p.slots) for p in placements[2:4]] == [
        (slice(4, 8), slice(0, 4)), (slice(4, 8), slice(4, 8))]
    gen = torch.Generator().manual_seed(0)
    st = init_state(cfg, "cpu").replace(
        poses=torch.randn(16, 3, generator=gen), lm_mean=torch.randn(16, 8, 2, generator=gen),
        lm_cov=torch.randn(16, 8, 4, generator=gen),
        lm_count=torch.randint(0, 9, (16,), generator=gen, dtype=torch.int32))
    shards = shard_state(st, mesh, cfg)
    assert len(shards) == 8
    assert all(s.lm_mean.shape == (4, 4, 2) and s.lm_mean.is_contiguous()
               and s.lm_cov.shape == (4, 4, 4) for s in shards)
    assert torch.equal(shards[3].lm_mean, st.lm_mean[4:8, 4:8])
    assert shards[2].poses is shards[3].poses and shards[2].lm_count is shards[3].lm_count
    assert_equal_states(unshard(shards, mesh), st, "unshard")
    with pytest.raises(ValueError, match="equal map shards"):
        state_sharding(make_mesh(cfg, ["cpu"] * 6, map_parallelism=3), 16, 8)
    with pytest.raises(ValueError, match="rows of 3"):
        make_mesh(cfg, ["cpu"] * 8, map_parallelism=3)
    with pytest.raises(ValueError, match="1-D particle-axis mesh"):
        planes_state_sharding(mesh, 16)
    assert planes_state_sharding(make_mesh(cfg, ["cpu"] * 4), 16)[1].particles == slice(4, 8)


def run_port(cfg, mesh, draws, ticks, ms):
    """``ticks`` steps from a fresh state on ``mesh`` (None: the
    single-device step); the final state gathered and the estimates."""
    state = init_state(cfg, "cpu")
    if mesh is None:
        est = []
        for d in draws[:ticks]:
            state, pose = kernels.fastslam_step(state, 0.0, 0.4, ms, cfg, d)
            est.append(pose)
        return state, torch.stack(est)
    step = make_sharded_step(cfg, mesh)
    shards, est = shard_state(state, mesh, cfg), []
    for d in draws[:ticks]:
        shards, pose = step(shards, 0.0, 0.4, ms, d)
        assert len(shards) == mesh.num_shards // mesh.num_processes
        est.append(pose)
    return unshard(shards, mesh), torch.stack(est)


@pytest.mark.parametrize("case", list(CASES))
def test_2d_mesh_step_matches_jax_and_one_shard(jax_mesh2d, case):
    """Two blocks steps on the 4 x 2 mesh against JAX's 2-D mesh step, and
    bit for bit against the port's S = 1 and single-device steps."""
    jcfg = jax_config(**CASES[case])
    cfg = port(jcfg)
    jms = jax_pad_measurements(jcfg, MS)
    jstep = jax_sharded.make_sharded_step(jcfg, jax_mesh2d)
    js = jax_mesh.shard_state(jax_init_state(jcfg, rng=3), jax_mesh2d, jcfg)
    draws = []
    for _ in range(2):
        draws.append(jax_draws(js.rng, 16, (16,), (16, 3)))
        js, jpose = jstep(js, jnp.float32(0.0), jnp.float32(0.4), jms)
    ms = pad_measurements(cfg, MS, "cpu")
    mesh2d = make_mesh(cfg, ["cpu"] * 8, map_parallelism=2)
    got, est = run_port(cfg, mesh2d, draws, 2, ms)
    tol = 1e-4 if kernels.uses_fs2(cfg) else 1e-5
    for k in ("poses", "log_weights", "lm_mean"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(js, k)),
                                   rtol=tol, atol=tol, err_msg=k)
    np.testing.assert_array_equal(got.lm_count.numpy(), np.asarray(js.lm_count))
    np.testing.assert_allclose(est[-1].numpy(), np.asarray(jpose), rtol=tol, atol=tol)
    assert int(got.lm_count.min()) == 2
    for other in (make_mesh(cfg, ["cpu"]), None):
        want, want_est = run_port(cfg, other, draws, 2, ms)
        assert_equal_states(got, want, other)
        assert torch.equal(est, want_est)


@pytest.mark.parametrize("proposal", ["motion", "fastslam2"])
def test_2d_mesh_resamples_like_one_shard(proposal):
    """Forced resamples (``resample_threshold_frac=1``) on the 4 x 2 mesh,
    through the whole-state gather and through the halo resampler
    (``distributed_resample``), equal the single-device step bit for bit."""
    gen = torch.Generator().manual_seed(5)
    fs2 = proposal == "fastslam2"
    draws = [kernels.draw(gen, 16, fs2=fs2) for _ in range(3)]
    for distributed in (False, True):
        cfg = port(jax_config(parity_mode=False, proposal_mode=proposal,
                              resample_threshold_frac=1.0,
                              distributed_resample=distributed))
        ms = pad_measurements(cfg, MS, "cpu")
        got, est = run_port(cfg, make_mesh(cfg, ["cpu"] * 8, map_parallelism=2), draws, 3, ms)
        want, want_est = run_port(cfg, None, draws, 3, ms)
        assert_equal_states(got, want, distributed)
        assert torch.equal(est, want_est)
        # resampled: production weights back to uniform
        assert bool((got.log_weights == got.log_weights[0]).all())


@pytest.mark.parametrize("profile", ["healthy", "collapsed"])
def test_2d_resamplers_move_slot_blocks_with_particles(profile):
    """``halo_systematic_resample`` and ``ring_halo_resample`` on a 4 x 2
    mesh (every map column its own ring) equal ``resample_state`` on the
    gathered state bit for bit, on the halo path and the fallback."""
    from fastslam_tpu_torch.parallel import dryrun

    cfg = port(jax_config(parity_mode=False, num_particles=32, max_landmarks=8))
    state = dryrun.resampler_state(cfg, "cpu", profile, seed=3)
    u0 = torch.tensor(0.0021)
    want = kernels.resample_state(
        state, kernels.systematic_resample_indices(torch.exp(state.log_weights), u0), cfg)
    mesh = make_mesh(cfg, ["cpu"] * 8, map_parallelism=2)
    for resample in (halo_systematic_resample,
                     lambda s, u, m, c: ring_halo_resample(s, u, m, c,
                                                           _exchange=_ppermute_exchange),
                     ring_halo_resample):
        shards = resample(shard_state(state, mesh, cfg), u0, mesh, cfg)
        assert len(shards) == 8 and shards[0].lm_mean.shape == (8, 4, 2)
        assert_equal_states(unshard(shards, mesh), want, profile)
