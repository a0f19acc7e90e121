"""The port's sharded steps at 8 shards against the JAX package's on its
8-device virtual CPU mesh (``tests/conftest.py``), and against one shard and
the port's single-device steps bit for bit.

Mirrors ``tests/test_sharded.py``.  The port's steps take their draws as
tensors: each JAX step's own ``jax.random.split(state.rng, 4)`` draws are
replayed into the port.  Floats at 1e-5 (the chunked fs2 trajectory at the
fs2 bar 1e-4), counts exact.  Where a tick resamples, its weights first lie
more than 1e-5 from every resample grid position (XLA's float cumulative sum
and the port's fixed-order one may round differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.core import kernels as jax_kernels
from fastslam_tpu.core.state import FilterState as JaxFilterState
from fastslam_tpu.core.state import Measurements as JaxMeasurements
from fastslam_tpu.core.state import PlanesState as JaxPlanesState
from fastslam_tpu.core.state import init_planes_state as jax_init_planes_state
from fastslam_tpu.parallel import mesh as jax_mesh
from fastslam_tpu.parallel import sharded as jax_sharded

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import (
    Measurements, init_planes_state, init_state, pad_measurements, to_planes,
)
from fastslam_tpu_torch.interop import (
    config_from_jax_fields, filter_state_from_numpy, planes_state_from_numpy,
    planes_state_to_numpy,
)
from fastslam_tpu_torch.parallel import dryrun
from fastslam_tpu_torch.parallel.mesh import (
    make_mesh, shard_planes_state, shard_state, unshard,
)
from fastslam_tpu_torch.parallel.sharded import (
    make_sharded_planes_chunked_step, make_sharded_planes_step, make_sharded_step,
)
from tests.test_torch_blocks import blocks_of, fs2_inputs, measurements
from tests.test_torch_fused_update import seeded_planes
from tests.test_torch_step import assert_away_from_grid

torch.set_num_threads(1)

MS = [(2.0, 0.3), (3.5, -0.7)]


@pytest.fixture(scope="module")
def jax_mesh8():
    assert len(jax.devices()) == 8, "conftest should provide 8 virtual devices"
    return jax_mesh.make_mesh(JaxConfig())


def port(jcfg):
    return config_from_jax_fields(dataclasses.asdict(jcfg))


def jax_draws(rng, p, shape_rot, shape_noise):
    """The draws a JAX step makes from its state's key ``rng``."""
    _, k_rot, k_trans, k_u = jax.random.split(rng, 4)
    normal = lambda k, shape: torch.tensor(np.asarray(jax.random.normal(k, shape, jnp.float32)))
    return kernels.Draws(
        rot=normal(k_rot, shape_rot), trans=normal(k_trans, shape_rot),
        u0=torch.tensor(float(jax.random.uniform(k_u, (), jnp.float32, maxval=1.0 / p))),
        noise=normal(k_rot, shape_noise))


def check_margin(single_step, state, cfg, u0):
    """If the port's single-device step would resample, its weights lie away
    from the grid (run on a copy with resampling off)."""
    out, _ = single_step(state.clone(), cfg.replace(resample_threshold_frac=0.0))
    log_w = out.log_weights
    if bool(kernels.effective_particles(log_w, cfg)
            < cfg.resample_threshold_frac * log_w.shape[0]):
        assert_away_from_grid(log_w.numpy(), u0)
        return 1
    return 0


def assert_close(got, want, tol, name):
    want = np.asarray(want)
    if want.dtype == np.int32:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


def test_state_shards_on_particle_axis():
    cfg = FastSLAMConfig(num_particles=64, max_landmarks=16, max_measurements=4,
                         parity_mode=False)
    mesh = make_mesh(cfg, ["cpu"] * 8)
    assert mesh.num_shards == 8
    st = init_state(cfg, "cpu").replace(poses=torch.randn(64, 3))
    shards = shard_state(st, mesh, cfg)
    assert [tuple(s.poses.shape) for s in shards] == [(8, 3)] * 8
    assert all(s.lm_mean.is_contiguous() and s.lm_mean.shape == (8, 16, 2) for s in shards)
    back = unshard(shards)
    assert all(torch.equal(a, b) for a, b in zip(back.__dict__.values(), st.__dict__.values()))
    # planes shard on their particle axis, each shard its own contiguous tensor
    ps = init_planes_state(cfg.replace(num_particles=128), "cpu")
    ps = ps.replace(lm_mx=torch.randn(16, 128))
    pshards = shard_planes_state(ps, mesh, cfg)
    assert all(s.lm_mx.shape == (16, 16) and s.lm_mx.is_contiguous() for s in pshards)
    assert pshards[3].lm_cc is None
    assert torch.equal(unshard(pshards).lm_mx, ps.lm_mx)
    with pytest.raises(ValueError, match="equal shards"):
        shard_state(init_state(cfg.replace(num_particles=60), "cpu"), mesh, cfg)


def test_mesh_refuses_what_is_not_ported():
    cfg = FastSLAMConfig()
    with pytest.raises(NotImplementedError, match="map-axis mesh"):
        make_mesh(cfg, ["cpu"] * 8, map_parallelism=2)
    with pytest.raises(NotImplementedError, match="distinct devices"):
        make_mesh(cfg, ["cpu", "meta"])
    with pytest.raises(ValueError):
        make_sharded_planes_chunked_step(cfg.replace(parity_mode=True),
                                         make_mesh(cfg, ["cpu"]), 4)
    with pytest.raises(ValueError, match="fs2"):
        make_sharded_planes_chunked_step(cfg.replace(parity_mode=False),
                                         make_mesh(cfg, ["cpu"]), 4, adaptive=True)


def seeded(p, l, m, parity, fs2, seed):
    """A blocks state with maps and widely spread weights (so that the
    first tick resamples), and the tick's measurements."""
    if fs2:
        st, z, z_valid, _ = fs2_inputs(p, l, m, seed)
    else:
        st = blocks_of(seeded_planes(p, l, seed=seed, fill=6, parity=parity))
        z, z_valid = measurements(m, seed + 1)
    st["log_weights"] = np.random.default_rng(seed + 2).normal(-3, 2.5, p).astype(np.float32)
    return st, z, z_valid


PALLAS = dict(use_pallas=True, pallas_interpret=True)
# parity normalizes in linear space, where XLA flushes the weights of
# log-weights below ~-87 to zero and torch keeps them (ROADMAP §3): a wider
# measurement noise keeps the parity cases' log-likelihoods above that
WIDE_R = dict(measurement_noise=0.05)
STEP_CASES = {
    "blocks motion parity": ("blocks", dict(parity_mode=True, **WIDE_R)),
    "blocks motion production": ("blocks", dict(parity_mode=False)),
    "blocks motion production, halo resample": (
        "blocks", dict(parity_mode=False, distributed_resample=True)),
    "blocks fs2": ("blocks", dict(parity_mode=False, proposal_mode="fastslam2")),
    "planes motion parity": ("planes", dict(parity_mode=True, **WIDE_R, **PALLAS)),
    "planes fs2": ("planes", dict(parity_mode=False, proposal_mode="fastslam2", **PALLAS)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_step_matches_jax(jax_mesh8, case):
    """Two ticks of the blocks or planes step at 8 shards, from a state whose
    weights make the ticks resample.

    Per tick, with resampling off, the port's step against JAX's sharded
    step on the 8-device mesh; with it on, against JAX's single-device step
    (and, for the halo resampler, its sharded step too).  JAX's sharded
    steps resample under GSPMD with a plain gather, which on the 8-device
    CPU mesh gives every particle past the first shard the last particle as
    ancestor (ROADMAP §3), so its GSPMD resample is not a reference here.
    For fs2, JAX's GSPMD step is its blocks step (its decomposed step, taken
    with ``distributed_resample``, samples the motion proposal only)."""
    layout, kw = STEP_CASES[case]
    blocks = layout == "blocks"
    p, l, m = (64 if blocks else 128), 16, 8
    jcfg = JaxConfig(num_particles=p, max_landmarks=l, max_measurements=m,
                     default_landmark_cov=0.125, **kw)
    cfg = port(jcfg)
    fs2 = kernels.uses_fs2(cfg)
    st, z, z_valid = seeded(p, l, m, cfg.parity_mode, fs2, seed=21)
    ms = Measurements(torch.from_numpy(z), torch.from_numpy(z_valid))
    jms = JaxMeasurements(jnp.asarray(z), jnp.asarray(z_valid))
    if blocks:
        fields = ("poses", "log_weights", "lm_mean", "lm_cov", "lm_count")
        js = JaxFilterState(**{k: jnp.asarray(v) for k, v in st.items()},
                            rng=jax.random.key(7))
        jmake, jshard, jsingle = (jax_sharded.make_sharded_step, jax_mesh.shard_state,
                                  jax_kernels.fastslam_step)
        state = filter_state_from_numpy(st, "cpu")
        make, shard, single = make_sharded_step, shard_state, kernels.fastslam_step
    else:
        fields = ("poses", "log_weights", "lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cd",
                  "lm_count")
        planes = planes_state_to_numpy(to_planes(filter_state_from_numpy(st, "cpu"), cfg))
        js = JaxPlanesState(**{k: None if v is None else jnp.asarray(v)
                               for k, v in planes.items()}, rng=jax.random.key(9))
        jmake, jshard, jsingle = (jax_sharded.make_sharded_planes_step,
                                  jax_mesh.shard_planes_state, jax_kernels.fastslam_step_planes)
        state = planes_state_from_numpy(planes, "cpu")
        make, shard, single = (make_sharded_planes_step, shard_planes_state,
                               kernels.fastslam_step_planes)
    jcfg0 = jcfg.replace(resample_threshold_frac=0.0)
    jstep1 = jax.jit(lambda s: jsingle(s, jnp.float32(0.0), jnp.float32(0.02), jms, jcfg))
    jstep8 = {c: jmake(c, jax_mesh8) for c in ((jcfg0, jcfg) if cfg.distributed_resample
                                               else (jcfg0,))}
    mesh = make_mesh(cfg, ["cpu"] * 8)
    tol = 1e-4 if fs2 else 1e-5

    def check(got_shards, got_pose, want_state, want_pose):
        got = unshard(got_shards)
        for k in fields:
            assert_close(getattr(got, k).numpy(), getattr(want_state, k), tol, k)
        np.testing.assert_allclose(got_pose.numpy(), np.asarray(want_pose), rtol=tol, atol=tol)

    resampled = 0
    for _ in range(2):
        draws = jax_draws(js.rng, p, (p,), (p, 3))
        resampled += check_margin(
            lambda s, c: single(s, 0.0, 0.02, ms, c, draws), state, cfg, draws.u0)
        for jc, jstep in jstep8.items():
            c = port(jc)
            check(*make(c, mesh)(shard(state.clone(), mesh, c), 0.0, 0.02, ms, draws),
                  *jstep(jshard(jax.tree.map(lambda x: x.copy(), js), jax_mesh8, jc),
                         jnp.float32(0.0), jnp.float32(0.02), jms))
        js, want_pose = jstep1(js)
        shards, pose = make(cfg, mesh)(shard(state, mesh, cfg), 0.0, 0.02, ms, draws)
        check(shards, pose, js, want_pose)
        assert len(shards) == 8
        state = unshard(shards)
    assert resampled >= 1


@pytest.mark.parametrize("proposal_mode,adaptive", [("motion", False), ("fastslam2", False),
                                                    ("fastslam2", True)])
def test_sharded_chunked_matches_jax(jax_mesh8, proposal_mode, adaptive):
    """Two chunks of 4 ticks at 8 shards against JAX's sharded chunked step;
    fs2 + adaptive with per-tick floors and the mode dial."""
    jcfg = JaxConfig(num_particles=128, max_landmarks=8, max_measurements=4,
                     parity_mode=False, use_pallas=True, pallas_interpret=True,
                     default_landmark_cov=0.125, proposal_mode=proposal_mode)
    cfg = port(jcfg)
    p, c = jcfg.num_particles, 4
    lms = np.asarray([[3.0, 1.0], [1.5, -2.0]])
    rb = np.zeros((c, 4, 2), np.float32)
    for k in range(c):
        d = lms - np.asarray([0.4 * (k + 1), 0.0])
        rb[k, :2, 0] = np.hypot(d[:, 0], d[:, 1])
        rb[k, :2, 1] = np.arctan2(d[:, 1], d[:, 0])
    valid = np.tile(np.asarray([True, True, False, False]), (c, 1))
    rots, trans = np.zeros(c, np.float32), np.full(c, 0.4, np.float32)
    rows = (np.array([0.004, 0.002, 0.001, 0.0008], np.float32),
            np.array([0.003, 0.001, 0.0008, 0.0006], np.float32),
            np.array([1.0, 0.6, 0.2, 0.0], np.float32)) if adaptive else ()
    jstep = jax_sharded.make_sharded_planes_chunked_step(jcfg, jax_mesh8, c,
                                                         adaptive=adaptive)
    js = jax_mesh.shard_planes_state(jax_init_planes_state(jcfg, rng=11), jax_mesh8, jcfg)
    mesh = make_mesh(cfg, ["cpu"] * 8)
    step = make_sharded_planes_chunked_step(cfg, mesh, c, adaptive=adaptive)
    shards = shard_planes_state(init_planes_state(cfg, "cpu"), mesh, cfg)
    ms = Measurements(torch.from_numpy(rb), torch.from_numpy(valid))
    tol = 1e-4 if proposal_mode == "fastslam2" else 1e-5
    for _ in range(2):
        draws = jax_draws(js.rng, p, (c, p), (c, 3, p))
        js, jest = jstep(js, jnp.asarray(rots), jnp.asarray(trans),
                         JaxMeasurements(jnp.asarray(rb), jnp.asarray(valid)),
                         *(jnp.asarray(r) for r in rows))
        shards, est = step(shards, torch.from_numpy(rots), torch.from_numpy(trans), ms,
                           draws, *(torch.from_numpy(r) for r in rows))
        got = unshard(shards)
        np.testing.assert_allclose(est.numpy(), np.asarray(jest), rtol=tol, atol=tol)
        for k in ("log_weights", "lm_mx", "lm_my", "lm_ca", "lm_cd", "lm_count"):
            assert_close(getattr(got, k).numpy(), getattr(js, k), tol, k)
    assert int(got.lm_count.min()) >= 2


@pytest.fixture(scope="module")
def dry_results():
    """Every step of the dry run at 128 particles on 8 CPU shards, on 1, and
    on the single-device steps, each from the same draws."""
    cfg = FastSLAMConfig(num_particles=128, max_landmarks=8, max_measurements=4,
                         resample_threshold_frac=1.0)
    ms = pad_measurements(cfg, MS, "cpu")
    return {n: dryrun.run_steps(cfg, n, "cpu", ms, chunk=4, ticks=3) for n in (8, 1, None)}


@pytest.mark.parametrize("mode", list(dryrun.MODES))
def test_eight_shards_agree_with_one_bit_for_bit(dry_results, mode):
    want = dry_results[None][mode]
    for n in (8, 1):
        got = dry_results[n][mode]
        assert torch.equal(got["est"], want["est"]), (n, "estimates")
        for k, v in want["state"].__dict__.items():
            g = getattr(got["state"], k)
            assert (v is None and g is None) or torch.equal(g, v), (n, k)
        assert len(got["shards"]) == n
    # the CPU runs no kernel
    assert dry_results[8][mode]["launches"] == {}
