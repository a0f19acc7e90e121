"""The port's plain FastSLAM 2.0 tick against the JAX Pallas kernel
(``fused_fs2_planes``, interpret mode), and the polynomial ``_sin_cos``.

Both sides start from the same seeded state, measurements and standard-normal
draws (numpy).  Poses at atol 2e-5, log-weights at 1e-4, planes at 2e-5 and
``lm_count`` exact: the bars ``tests/test_fastslam2_proposal.py`` holds the
fused kernel to against the XLA path.  Covariances are powers of two and
appends use ``default_landmark_cov=0.125``: interpret mode evaluates the
kernel's approximate reciprocal in bfloat16, exact only for such
determinants (see ``tests/test_torch_fused_update.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.core.kernels import fs2_prior_scalars as jax_fs2_prior_scalars
from fastslam_tpu.core.pallas_kernels import _sin_cos as jax_sin_cos
from fastslam_tpu.core.pallas_kernels import fused_fs2_planes as jax_fused_fs2_planes

from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.core.cuda_kernels.filter import _sin_cos
from fastslam_tpu_torch.interop import config_from_jax_fields

torch.set_num_threads(1)

FS2_PLANES = ("lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cd")


def fs2_config(p, l, m, evidence=False):
    return JaxConfig(num_particles=p, max_landmarks=l, max_measurements=m,
                     parity_mode=False, proposal_mode="fastslam2",
                     fs2_evidence_weights=evidence, use_pallas=True,
                     pallas_interpret=True, default_landmark_cov=0.125)


def mapped_state(p, l, seed, fill):
    """A filter that has mapped a shared set of landmarks: every particle
    holds the first ``lm_count`` of them (means 1 cm apart between
    particles, isotropic power-of-two covariances), poses near the origin,
    non-uniform weights.  Returns the state and the landmarks' positions."""
    rng = np.random.default_rng(seed)
    world = rng.uniform(-4.0, 4.0, (l, 2)).astype(np.float32)
    poses = np.zeros((p, 3), np.float32)
    poses[:, :2] = rng.normal(0, 0.02, (p, 2))
    poses[:, 2] = rng.normal(0, 0.01, p)
    cov = (2.0 ** rng.integers(-7, -3, (l, p))).astype(np.float32)
    st = {
        "poses": poses,
        "log_weights": rng.normal(-5, 0.5, p).astype(np.float32),
        "lm_mx": (world[:, :1] + rng.normal(0, 0.01, (l, p))).astype(np.float32),
        "lm_my": (world[:, 1:] + rng.normal(0, 0.01, (l, p))).astype(np.float32),
        "lm_ca": cov,
        "lm_cb": np.zeros((l, p), np.float32),
        "lm_cd": cov.copy(),
        "lm_count": rng.integers(fill // 2, fill + 1, p).astype(np.int32),
    }
    return st, world


def observe(world, idx, rng, extra=()):
    """(range, bearing) from the origin to the landmarks ``idx`` (positions
    in the robot frame) with 1 cm / 5 mrad noise, then the ``extra``
    (range, bearing) pairs."""
    w = world[list(idx)]
    z = np.stack([np.hypot(w[:, 0], w[:, 1]) + rng.normal(0, 0.01, len(idx)),
                  np.arctan2(w[:, 1], w[:, 0]) + rng.normal(0, 0.005, len(idx))], -1)
    return np.concatenate([z, np.asarray(extra, np.float64).reshape(-1, 2)]).astype(np.float32)


def prior_scalars(jcfg, rotation, translation, floors=None):
    """The tick's (s_t2, s_r2, fxy) from the JAX function, as numpy."""
    jf = None if floors is None else tuple(jnp.asarray(f, jnp.float32) for f in floors)
    _, _, s_t2, s_r2, fxy = jax_fs2_prior_scalars(
        jnp.asarray(rotation, jnp.float32), jnp.asarray(translation, jnp.float32),
        jcfg, jf)
    return tuple(np.asarray(v, np.float32) for v in (s_t2, s_r2, fxy))


def run_both(st, z, z_valid, noise, prior, jcfg, evidence_scale=None):
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    j = lambda k: jnp.asarray(st[k])
    want = jax_fused_fs2_planes(
        j("poses"), j("log_weights"), j("lm_mx"), j("lm_my"), j("lm_ca"),
        j("lm_cb"), None, j("lm_cd"), j("lm_count"), jnp.asarray(z),
        jnp.asarray(z_valid), jnp.asarray(noise), *(jnp.asarray(v) for v in prior),
        jcfg, interpret=True,
        evidence_scale=None if evidence_scale is None else jnp.float32(evidence_scale),
    )
    t = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    got = cuda_kernels.fused_fs2_planes(
        t["poses"], t["log_weights"], t["lm_mx"], t["lm_my"], t["lm_ca"],
        t["lm_cb"], None, t["lm_cd"], t["lm_count"], torch.from_numpy(z),
        torch.from_numpy(z_valid), torch.from_numpy(noise),
        *(torch.tensor(v) for v in prior), cfg,
        evidence_scale=None if evidence_scale is None else torch.tensor(evidence_scale),
    )
    return want, got


def assert_fs2_matches(want, got):
    """(poses, logw, mx, my, ca, cb, cc, cd, cnt) at the stated bars."""
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=2e-5, err_msg="poses")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-4, err_msg="log_weights")
    assert want[6] is None and got[6] is None        # no cc plane
    for name, w, g in zip(FS2_PLANES, want[2:6] + want[7:8], got[2:6] + got[7:8]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(got[8].numpy(), np.asarray(want[8]))


def tick_inputs(p, m, seed, world, n_seen):
    rng = np.random.default_rng(seed)
    z = np.zeros((m, 2), np.float32)
    seen = observe(world, range(n_seen), rng, extra=[(6.5, 2.9)])   # + one new
    z[: len(seen)] = seen
    z_valid = np.arange(m) < len(seen)
    z_valid[1] = False                                  # interior hole
    noise = rng.standard_normal((p, 3)).astype(np.float32)
    return z, z_valid, noise


@pytest.mark.parametrize("evidence,scale,rotating", [
    (False, None, False), (True, None, False), (False, 0.37, True), (True, 0.37, True),
])
def test_fused_fs2_matches_jax(evidence, scale, rotating):
    """Matches, the chi^2 gate, an append and an interior hole; both
    weightings (EKF pass or evidence) and the mode dial."""
    p, l, m = 256, 16, 8
    jcfg = fs2_config(p, l, m, evidence)
    st, world = mapped_state(p, l, seed=41, fill=10)
    z, z_valid, noise = tick_inputs(p, m, 42, world, n_seen=6)
    prior = prior_scalars(jcfg, 0.2 if rotating else 0.0, 0.0 if rotating else 0.3)
    want, got = run_both(st, z, z_valid, noise, prior, jcfg, scale)
    assert_fs2_matches(want, got)
    assert (got[8].numpy() > st["lm_count"]).any()           # appended
    assert (got[1].numpy() != st["log_weights"]).any()        # weighted
    # the measurements pulled the sample: it is not the prior-only draw
    prior_only = run_both(st, z, np.zeros(m, bool), noise, prior, jcfg)[1][0]
    assert np.abs(got[0].numpy() - prior_only.numpy()).max() > 1e-3


def test_fused_fs2_custom_floors_and_full_capacity():
    """Floors passed as traced values; half the particles at capacity drop
    their unmatched measurement."""
    p, l, m = 128, 8, 4
    jcfg = fs2_config(p, l, m)
    st, world = mapped_state(p, l, seed=43, fill=l)
    st["lm_count"][: p // 2] = l
    z, z_valid, noise = tick_inputs(p, m, 44, world, n_seen=2)
    prior = prior_scalars(jcfg, 0.0, 0.3, floors=(0.03, 0.02))
    want, got = run_both(st, z, z_valid, noise, prior, jcfg)
    assert_fs2_matches(want, got)
    assert (got[8].numpy()[: p // 2] == l).all()


def test_fused_fs2_without_measurements_samples_the_prior():
    """No valid measurement: the pose is the motion-prior sample, the map
    and weights stay as they were."""
    p, l, m = 128, 8, 4
    jcfg = fs2_config(p, l, m, evidence=True)
    st, world = mapped_state(p, l, seed=45, fill=6)
    z, _, noise = tick_inputs(p, m, 46, world, n_seen=2)
    prior = prior_scalars(jcfg, 0.1, 0.0)
    want, got = run_both(st, z, np.zeros(m, bool), noise, prior, jcfg)
    assert_fs2_matches(want, got)
    np.testing.assert_array_equal(got[1].numpy(), st["log_weights"])
    np.testing.assert_array_equal(got[2].numpy(), st["lm_mx"])


def test_sin_cos_matches_jax_and_exact_trig():
    x = np.linspace(-np.pi, np.pi, 200_001).astype(np.float32)
    s, c = _sin_cos(torch.from_numpy(x))
    js, jc = jax_sin_cos(jnp.asarray(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=3e-7)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=3e-7)
    xt = torch.from_numpy(x)
    assert (s - torch.sin(xt)).abs().max() < 3e-7
    assert (c - torch.cos(xt)).abs().max() < 3e-7
