"""The port's blocks-layout engine against the JAX package's.

``associate``, ``update_particles`` (the JAX scan path), the blocks wrapper
``fused_update`` (against the JAX wrapper in Pallas interpret mode),
``fastslam2_propose``, ``resample_state`` and ``fastslam_step`` on the same
numpy inputs, with JAX's own draws (``jax.random.split(state.rng, 4)``)
replayed into the port's step; and ``to_planes``/``from_planes``.  Counts
and indices exact, floats at 1e-5 (the proposal's poses and weights at the
fs2 bars of ``tests/test_torch_fused_fs2.py``).  Where a step resamples, the
weights it resamples first lie more than 1e-5 from every grid position (the
cumulative sums of XLA and of the port may round differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.core import kernels as jax_kernels
from fastslam_tpu.core import state as jax_state_mod
from fastslam_tpu.core.pallas_kernels import fused_update as jax_fused_update
from fastslam_tpu.core.state import Measurements as JaxMeasurements

from fastslam_tpu_torch.core import cuda_kernels, kernels, state as state_mod
from fastslam_tpu_torch.core.state import Measurements
from fastslam_tpu_torch.interop import (
    config_from_jax_fields, filter_state_from_numpy, filter_state_to_numpy,
    planes_state_to_numpy,
)
from tests.test_torch_fused_fs2 import mapped_state, observe
from tests.test_torch_fused_update import seeded_planes
from tests.test_torch_step import assert_away_from_grid

torch.set_num_threads(1)

BLOCKS = ("poses", "log_weights", "lm_mean", "lm_cov", "lm_count")


def blocks_of(planes):
    """A numpy planes-state dict -> the blocks-layout dict (cc = cb when the
    planes carry no cc plane)."""
    cc = planes.get("lm_cc")
    cc = planes["lm_cb"] if cc is None else cc
    return {
        "poses": planes["poses"], "log_weights": planes["log_weights"],
        "lm_mean": np.stack([planes["lm_mx"].T, planes["lm_my"].T], -1),
        "lm_cov": np.stack([planes["lm_ca"].T, planes["lm_cb"].T, cc.T,
                            planes["lm_cd"].T], -1),
        "lm_count": planes["lm_count"],
    }


def jax_config(parity, p, l, m, **kw):
    return JaxConfig(num_particles=p, max_landmarks=l, max_measurements=m,
                     parity_mode=parity, default_landmark_cov=0.125, **kw)


def port_config(jcfg):
    return config_from_jax_fields(dataclasses.asdict(jcfg))


def jax_filter_state(st, seed):
    return jax_state_mod.FilterState(**{k: jnp.asarray(st[k]) for k in BLOCKS},
                                     rng=jax.random.key(seed))


def assert_blocks_match(got, want, tol=1e-5):
    """``got`` a port FilterState, ``want`` a JAX one."""
    g = filter_state_to_numpy(got)
    for k in BLOCKS:
        w = np.asarray(getattr(want, k))
        if k == "lm_count":
            np.testing.assert_array_equal(g[k], w)
        else:
            np.testing.assert_allclose(g[k], w, rtol=tol, atol=tol, err_msg=k)


def measurements(m, seed, n_valid=6):
    rng = np.random.default_rng(seed)
    z = np.stack([rng.uniform(0.5, 5.0, m), rng.uniform(-3.0, 3.0, m)], -1).astype(np.float32)
    z_valid = np.arange(m) < n_valid
    z_valid[1] = False                                  # interior hole
    return z, z_valid


@pytest.mark.parametrize("parity", [False, True])
def test_associate_matches_jax(parity):
    p, l = 128, 16
    st = blocks_of(seeded_planes(p, l, seed=1, fill=10, parity=parity))
    jcfg = jax_config(parity, p, l, 4)
    query = np.random.default_rng(2).normal(0, 3, (p, 2)).astype(np.float32)
    valid = np.arange(l)[None, :] < st["lm_count"][:, None]
    want = jax_kernels.associate(jnp.asarray(st["lm_mean"]), jnp.asarray(st["lm_cov"]),
                                 jnp.asarray(valid), jnp.asarray(query), jcfg)
    got = kernels.associate(torch.from_numpy(st["lm_mean"]), torch.from_numpy(st["lm_cov"]),
                            torch.from_numpy(valid), torch.from_numpy(query),
                            port_config(jcfg))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1].any() and not got[1].all()


@pytest.mark.parametrize("parity,update_weights", [(False, True), (True, True),
                                                    (False, False)])
def test_update_particles_matches_jax(parity, update_weights):
    """Matches, appends, an interior invalid measurement; half the particles
    at capacity drop their appends."""
    p, l, m = 128, 16, 8
    jcfg = jax_config(parity, p, l, m)
    st = blocks_of(seeded_planes(p, l, seed=3, fill=10, parity=parity))
    st["lm_count"][: p // 4] = l
    z, z_valid = measurements(m, seed=4)
    js = jax_filter_state(st, 0)
    want = jax_kernels.update_particles(js, JaxMeasurements(jnp.asarray(z),
                                                            jnp.asarray(z_valid)),
                                        jcfg, update_weights=update_weights)
    got = kernels.update_particles(filter_state_from_numpy(st, "cpu"),
                                   Measurements(torch.from_numpy(z), torch.from_numpy(z_valid)),
                                   port_config(jcfg), update_weights=update_weights)
    assert_blocks_match(got, want)
    assert (got.lm_count.numpy() > st["lm_count"]).any()
    changed = (got.log_weights.numpy() != st["log_weights"]).any()
    assert changed == update_weights


@pytest.mark.parametrize("parity", [False, True])
def test_fused_update_matches_jax(parity):
    """The blocks wrapper over the per-tick kernel (its plain version on the
    CPU) against the JAX wrapper in interpret mode."""
    p, l, m = 128, 16, 8
    jcfg = jax_config(parity, p, l, m, use_pallas=True, pallas_interpret=True)
    st = blocks_of(seeded_planes(p, l, seed=5, fill=10, parity=parity))
    z, z_valid = measurements(m, seed=6)
    want = jax_fused_update(*(jnp.asarray(st[k]) for k in BLOCKS), jnp.asarray(z),
                            jnp.asarray(z_valid), jcfg, interpret=True)
    args = [torch.from_numpy(st[k].copy()) for k in BLOCKS]
    got = cuda_kernels.fused_update(*args, torch.from_numpy(z), torch.from_numpy(z_valid),
                                    port_config(jcfg))
    for name, g, w in zip(("log_weights", "lm_mean", "lm_cov", "lm_count"), got, want):
        if name == "lm_count":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    for t, k in zip(args, BLOCKS):                       # the inputs are untouched
        np.testing.assert_array_equal(t.numpy(), st[k])


def fs2_inputs(p, l, m, seed):
    planes, world = mapped_state(p, l, seed=seed, fill=10)
    st = blocks_of(planes)
    rng = np.random.default_rng(seed + 1)
    z = np.zeros((m, 2), np.float32)
    seen = observe(world, range(5), rng, extra=[(6.5, 2.9)])
    z[: len(seen)] = seen
    z_valid = np.arange(m) < len(seen)
    z_valid[1] = False
    noise = rng.standard_normal((p, 3)).astype(np.float32)
    return st, z, z_valid, noise


@pytest.mark.parametrize("evidence,floors,dial", [
    (False, None, None), (True, None, None), (True, (0.004, 0.003), 0.37),
])
def test_fastslam2_propose_matches_jax(evidence, floors, dial):
    p, l, m = 128, 16, 8
    jcfg = jax_config(False, p, l, m, proposal_mode="fastslam2",
                      fs2_evidence_weights=evidence)
    st, z, z_valid, noise = fs2_inputs(p, l, m, seed=7)
    jf = (None, None) if floors is None else tuple(jnp.float32(f) for f in floors)
    tf = (None, None) if floors is None else tuple(torch.tensor(f) for f in floors)
    want, want_pred = jax_kernels.fastslam2_propose(
        jax_filter_state(st, 0), jnp.float32(0.0), jnp.float32(0.02),
        JaxMeasurements(jnp.asarray(z), jnp.asarray(z_valid)), jnp.asarray(noise), jcfg,
        xy_floor=jf[0], theta_floor=jf[1],
        evidence_scale=None if dial is None else jnp.float32(dial))
    got, pred = kernels.fastslam2_propose(
        filter_state_from_numpy(st, "cpu"), 0.0, 0.02,
        Measurements(torch.from_numpy(z), torch.from_numpy(z_valid)),
        torch.from_numpy(noise), port_config(jcfg), tf[0], tf[1],
        None if dial is None else torch.tensor(dial))
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.log_weights.numpy(), np.asarray(want.log_weights),
                               rtol=0, atol=1e-4)
    # the proposal moved the poses off the prediction, and only evidence weights
    assert np.abs(got.poses.numpy() - pred.numpy()).max() > 1e-4
    assert (got.log_weights.numpy() != st["log_weights"]).any() == evidence


@pytest.mark.parametrize("parity", [False, True])
def test_resample_state_and_estimate_match_jax(parity):
    p, l = 128, 8
    jcfg = jax_config(parity, p, l, 4)
    st = blocks_of(seeded_planes(p, l, seed=9, fill=4, parity=parity))
    idx = np.sort(np.random.default_rng(10).integers(0, p, p)).astype(np.int32)
    js = jax_filter_state(st, 0)
    want = jax_kernels.resample_state(js, jnp.asarray(idx), jcfg)
    got = kernels.resample_state(filter_state_from_numpy(st, "cpu"), torch.from_numpy(idx),
                                 port_config(jcfg))
    assert_blocks_match(got, want, tol=0)
    np.testing.assert_array_equal(kernels.estimate_pose(got).numpy(),
                                  np.asarray(jax_kernels.estimate_pose(want)))


def jax_draws(js, fs2):
    """The draws the JAX blocks step makes from its state's key."""
    _, k_rot, k_trans, k_u = jax.random.split(js.rng, 4)
    p = js.num_particles
    normal = lambda k, shape: torch.tensor(np.asarray(jax.random.normal(k, shape, jnp.float32)))
    u0 = torch.tensor(float(jax.random.uniform(k_u, (), jnp.float32, maxval=1.0 / p)))
    if fs2:
        return kernels.Draws(None, None, u0, normal(k_rot, (p, 3)))
    return kernels.Draws(normal(k_rot, (p,)), normal(k_trans, (p,)), u0)


# the keys put every resample of the two ticks clear of the grid
STEP_CASES = {
    "motion production": dict(parity=False, key=14),
    "motion parity": dict(parity=True, key=14),
    "fs2": dict(parity=False, proposal_mode="fastslam2", key=18),
    "fs2 adaptive": dict(parity=False, proposal_mode="fastslam2",
                         floors=(0.004, 0.002), dial=0.5, key=18),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_fastslam_step_matches_jax(case):
    """Two ticks of the full blocks step from the same state and draws; the
    weight spread makes at least one of them resample."""
    kw = dict(STEP_CASES[case])
    parity, key = kw.pop("parity"), kw.pop("key")
    floors, dial = kw.pop("floors", None), kw.pop("dial", None)
    p, l, m = 128, 16, 8
    jcfg = jax_config(parity, p, l, m, **kw)
    cfg = port_config(jcfg)
    fs2 = kernels.uses_fs2(cfg)
    if fs2:
        st, z, z_valid, _ = fs2_inputs(p, l, m, seed=11)
    else:
        st = blocks_of(seeded_planes(p, l, seed=11, fill=6, parity=parity))
        z, z_valid = measurements(m, seed=12)
    st["log_weights"] = np.random.default_rng(13).normal(-3, 2.5, p).astype(np.float32)
    jkw, tkw = {}, {}
    if floors is not None:
        jkw = {"proposal_floors": tuple(jnp.float32(f) for f in floors),
               "evidence_scale": jnp.float32(dial)}
        tkw = {"proposal_floors": tuple(torch.tensor(f) for f in floors),
               "evidence_scale": torch.tensor(dial)}
    jms = JaxMeasurements(jnp.asarray(z), jnp.asarray(z_valid))
    ms = Measurements(torch.from_numpy(z), torch.from_numpy(z_valid))
    js = jax_filter_state(st, seed=key)
    state = filter_state_from_numpy(st, "cpu")
    resampled = 0
    for _ in range(2):
        draws = jax_draws(js, fs2)
        pre, _ = jax_kernels.fastslam_step(
            js, jnp.float32(0.0), jnp.float32(0.02), jms,
            jcfg.replace(resample_threshold_frac=0.0), **jkw)
        js, want_pose = jax_kernels.fastslam_step(js, jnp.float32(0.0), jnp.float32(0.02),
                                                  jms, jcfg, **jkw)
        if not np.array_equal(np.asarray(pre.log_weights), np.asarray(js.log_weights)):
            assert_away_from_grid(pre.log_weights, draws.u0)
            resampled += 1
        state, pose = kernels.fastslam_step(state, 0.0, 0.02, ms, cfg, draws, **tkw)
        tol = 1e-4 if fs2 else 1e-5
        assert_blocks_match(state, js, tol=tol)
        np.testing.assert_allclose(pose.numpy(), np.asarray(want_pose), rtol=tol, atol=tol)
    assert resampled >= 1


@pytest.mark.parametrize("parity", [False, True])
def test_planes_round_trip_matches_jax(parity):
    p, l = 128, 8
    jcfg = jax_config(parity, p, l, 4)
    st = blocks_of(seeded_planes(p, l, seed=15, fill=5, parity=parity))
    js = jax_filter_state(st, 0)
    state = filter_state_from_numpy(st, "cpu")
    want = jax_state_mod.to_planes(js, jcfg)
    got = state_mod.to_planes(state, port_config(jcfg))
    got_np = planes_state_to_numpy(got)
    for k in ("poses", "log_weights", "lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cc",
              "lm_cd", "lm_count"):
        w = getattr(want, k)
        if w is None:
            assert got_np[k] is None, k
        else:
            np.testing.assert_array_equal(got_np[k], np.asarray(w), err_msg=k)
    assert (got.lm_cc is None) == (not parity)
    assert all(t is None or t.is_contiguous() for t in got.__dict__.values())
    back = state_mod.from_planes(got)
    want_back = jax_state_mod.from_planes(want)
    assert_blocks_match(back, want_back, tol=0)
    for k in BLOCKS:           # and back to the start: cc == cb in production
        np.testing.assert_array_equal(filter_state_to_numpy(back)[k], st[k], err_msg=k)
    assert state_mod.planes_particle_count(p + 3) == p + 3


def test_init_state_and_interop():
    cfg = port_config(jax_config(False, 48, 8, 4))
    s = state_mod.init_state(cfg, "cpu")
    want = jax_state_mod.init_state(jax_config(False, 48, 8, 4), rng=0)
    assert_blocks_match(s, want, tol=0)
    assert s.lm_count.dtype == torch.int32 and not s.lm_valid_mask().any()
    again = filter_state_from_numpy(filter_state_to_numpy(s), "cpu")
    for k in BLOCKS:
        assert torch.equal(getattr(again, k), getattr(s, k))
    with pytest.raises(KeyError):
        filter_state_from_numpy({"poses": np.zeros((4, 3))}, "cpu")
