"""The port's distributed resamplers against the single-device resampler and
the JAX package's ring resampler, and the sharded dry run.

Mirrors ``tests/test_distributed_resample.py``: ``halo_systematic_resample``
and ``ring_halo_resample`` (with the plain exchange, and with the exchange
kernel's wrapper, which runs the kernel's plain version on the CPU) at
S in {1, 2, 8} shards, on healthy weights (the halo path) and weights
collapsed onto the last shard (the full-gather fallback).  Both must equal
the port's single-device ``resample_state`` bit for bit, and JAX's ring
resampler (its ppermute exchange, on the 8 virtual CPU devices) exactly in
the indices and counts and within 1e-6 in the floats.  The test data lies
more than 1e-5 from every resample grid position, where XLA's float
cumulative sum and the port's fixed-order one could pick other ancestors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.core.state import FilterState as JaxFilterState
from fastslam_tpu.parallel import mesh as jax_mesh
from fastslam_tpu.parallel.ring_resample import _ppermute_exchange as jax_ppermute_exchange
from fastslam_tpu.parallel.ring_resample import ring_halo_resample as jax_ring_halo_resample

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels, kernels
from fastslam_tpu_torch.core.state import init_state, pad_measurements
from fastslam_tpu_torch.interop import filter_state_from_numpy
from fastslam_tpu_torch.parallel import dryrun
from fastslam_tpu_torch.parallel.mesh import make_mesh, shard_state, unshard
from fastslam_tpu_torch.parallel.resample import (
    halo_systematic_resample, pack_particle_block, shard_ancestor_window,
    unpack_particle_block,
)
from fastslam_tpu_torch.parallel.ring_resample import _ppermute_exchange, ring_halo_resample
from fastslam_tpu_torch.parallel.sharded import make_sharded_step
from tests.test_torch_step import assert_away_from_grid

torch.set_num_threads(1)

P, L = 64, 8
FIELDS = ("poses", "log_weights", "lm_mean", "lm_cov", "lm_count")
U0 = {"healthy": 0.004, "collapsed": 0.007}


def make_state(profile, seed=5):
    """As ``tests/test_distributed_resample.py:make_state``, with random
    covariances too."""
    rng = np.random.default_rng(seed)
    if profile == "healthy":
        w = rng.uniform(0.8, 1.2, P)
    else:
        w = np.full(P, 1e-9)
        w[-3:] = 1.0                     # all mass on the last shard
    w = (w / w.sum()).astype(np.float32)
    return {
        "poses": rng.normal(0, 1, (P, 3)).astype(np.float32),
        "log_weights": np.log(w),
        "lm_mean": rng.normal(0, 3, (P, L, 2)).astype(np.float32),
        "lm_cov": rng.uniform(0.01, 0.2, (P, L, 4)).astype(np.float32),
        "lm_count": rng.integers(0, 4, P).astype(np.int32),
    }


@pytest.fixture(scope="module", params=["healthy", "collapsed"])
def case(request):
    """The state, u0, the single-device result, and JAX's ring at 1, 2 and
    8 devices (jitted once per mesh)."""
    profile = request.param
    st, u0 = make_state(profile), U0[profile]
    assert_away_from_grid(st["log_weights"], u0)
    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, parity_mode=False)
    state = filter_state_from_numpy(st, "cpu")
    u0_t = torch.tensor(u0)
    want = kernels.resample_state(
        state, kernels.systematic_resample_indices(torch.exp(state.log_weights), u0_t), cfg)
    jcfg = JaxConfig(num_particles=P, max_landmarks=L, parity_mode=False)
    js = JaxFilterState(**{k: jnp.asarray(v) for k, v in st.items()}, rng=jax.random.key(0))
    jax_rings = {}
    for n in (1, 2, 8):
        mesh = jax_mesh.make_mesh(jcfg, devices=jax.devices()[:n])
        ring = jax.jit(lambda s, u, mesh=mesh: jax_ring_halo_resample(
            s, u, mesh, jcfg, _exchange=jax_ppermute_exchange))
        jax_rings[n] = ring(jax_mesh.shard_state(js, mesh, jcfg), jnp.float32(u0))
    return {"profile": profile, "state": state, "u0": u0_t, "cfg": cfg, "want": want,
            "jax": jax_rings}


def assert_bitwise(got, want):
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.parametrize("n", [1, 2, 8])
def test_halo_resample_matches_single_device(case, n):
    cfg = case["cfg"]
    mesh = make_mesh(cfg, ["cpu"] * n)
    shards = halo_systematic_resample(shard_state(case["state"], mesh, cfg), case["u0"],
                                      mesh, cfg)
    assert len(shards) == n
    assert_bitwise(unshard(shards), case["want"])


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("exchange", ["plain", "kernel wrapper"])
def test_ring_resample_matches_single_device_and_jax(case, n, exchange):
    cfg = case["cfg"]
    mesh = make_mesh(cfg, ["cpu"] * n)
    launches = dict(cuda_kernels.LAUNCHES)
    shards = ring_halo_resample(
        shard_state(case["state"], mesh, cfg), case["u0"], mesh, cfg,
        _exchange=_ppermute_exchange if exchange == "plain" else None)
    assert cuda_kernels.LAUNCHES == launches          # the CPU runs no kernel
    got = unshard(shards)
    assert_bitwise(got, case["want"])
    assert all(s.lm_cov.shape == (P // n, L, 4) and s.lm_cov.is_contiguous() for s in shards)
    js = case["jax"][n]
    for k in FIELDS:
        w = np.asarray(getattr(js, k))
        if k == "lm_count":
            np.testing.assert_array_equal(getattr(got, k).numpy(), w)
        else:
            np.testing.assert_allclose(getattr(got, k).numpy(), w, rtol=0, atol=1e-6,
                                       err_msg=k)
    # collapsed onto the last shard, the first shard's window misses it at 8
    # shards only (at 2 the last shard is its right neighbour)
    use_halo = shard_ancestor_window([s.log_weights for s in shard_state(
        case["state"], mesh, cfg)], case["u0"])[2]
    assert use_halo == (case["profile"] == "healthy" or n <= 2)


def test_pack_unpack_round_trip():
    st = filter_state_from_numpy(make_state("healthy"), "cpu")
    block = pack_particle_block(st.poses, st.log_weights, st.lm_mean, st.lm_cov, st.lm_count)
    assert block.shape == (P, 3 + 1 + 6 * L + 1) and block.is_contiguous()
    back = unpack_particle_block(block, L)
    for k, v in zip(FIELDS, back):
        assert v.dtype == getattr(st, k).dtype and torch.equal(v, getattr(st, k)), k
    assert back[3].shape == (P, L, 4)


@pytest.mark.parametrize("s", [1, 2, 3])
def test_exchange_plain_version_moves_the_neighbours(s):
    blocks = [torch.full((5, 7), float(k)) for k in range(s)]
    lefts, rights = cuda_kernels.ring_halo_exchange(blocks)       # CPU: the plain version
    assert [float(b[0, 0]) for b in lefts] == [float((k - 1) % s) for k in range(s)]
    assert [float(b[0, 0]) for b in rights] == [float((k + 1) % s) for k in range(s)]
    assert all(b.data_ptr() != a.data_ptr() for b, a in zip(lefts + rights, blocks * 2))
    with pytest.raises(ValueError, match="float32"):
        cuda_kernels.ring_halo_exchange(blocks + [torch.zeros(4, 7)])
    with pytest.raises(ValueError, match="float32"):
        cuda_kernels.ring_halo_exchange(blocks + [torch.zeros(5, 7, dtype=torch.float64)])


def test_sharded_step_with_distributed_resample_matches_the_gather():
    """Four ticks of the sharded blocks step with the halo resampler equal the
    same step with the gather resample, bit for bit."""
    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=4,
                         parity_mode=False, resample_threshold_frac=1.0)
    ms = pad_measurements(cfg, [(2.0, 0.3), (3.5, -0.7)], "cpu")
    mesh = make_mesh(cfg, ["cpu"] * 8)
    gen = torch.Generator().manual_seed(9)
    draws = [kernels.draw(gen, P) for _ in range(4)]
    runs = {}
    for distributed in (False, True):
        c = cfg.replace(distributed_resample=distributed)
        step = make_sharded_step(c, mesh)
        shards = shard_state(init_state(c, "cpu"), mesh, c)
        poses = []
        for d in draws:
            shards, pose = step(shards, 0.0, 0.4, ms, d)
            poses.append(pose)
        runs[distributed] = (unshard(shards), torch.stack(poses))
    assert_bitwise(runs[True][0], runs[False][0])
    assert torch.equal(runs[True][1], runs[False][1])


def test_dryrun_at_8_shards():
    results = dryrun.dryrun_multichip(8, "cpu", ticks=3)
    assert results["resample"] == {"ring_launches": 0, "halo_path": 1}
    assert set(results) == set(dryrun.MODES) | {"resample"}
    for mode, r in results.items():
        if mode != "resample":
            assert r["launches"] == {} and len(r["shards"]) == 8
    # the chunked steps resampled at the boundary (uniform weights after)
    lw = results["chunked motion"]["state"].log_weights
    assert torch.equal(lw, torch.full_like(lw, lw[0].item()))
