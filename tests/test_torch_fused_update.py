"""The port's plain fused update against the JAX Pallas kernel (interpret mode).

Both sides start from the same seeded state and measurements (numpy), in
production and parity mode.  ``lm_count`` must match exactly; floats at the
1e-5 tolerance ``tests/test_pallas.py`` holds the kernel to.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.core.pallas_kernels import fused_update_planes as jax_fused_update_planes

from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.interop import config_from_jax_fields

torch.set_num_threads(1)

PLANES = ("lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cc", "lm_cd")


def seeded_planes(p, l, seed, fill, parity):
    """Planes state with partially filled maps and non-uniform weights.

    Covariances are isotropic powers of two (and the test configs append at
    ``default_landmark_cov=0.125``): interpret mode evaluates the production
    kernel's ``pl.reciprocal(approx=True)`` in bfloat16, which is exact only
    for such determinants, while the port divides exactly.  Poses stay near
    the origin, so the parity robot-frame quirk does not produce the
    metre-scale innovations that amplify last-bit differences past 1e-5.
    """
    rng = np.random.default_rng(seed)
    poses = np.zeros((p, 3), np.float32)
    poses[:, :2] = rng.normal(0, 0.1, (p, 2))
    poses[:, 2] = rng.normal(0, 0.05, p)
    cov = (2.0 ** rng.integers(-4, -1, (l, p))).astype(np.float32)
    st = {
        "poses": poses,
        "log_weights": rng.normal(-3, 0.5, p).astype(np.float32),
        "lm_mx": rng.normal(0, 3, (l, p)).astype(np.float32),
        "lm_my": rng.normal(0, 3, (l, p)).astype(np.float32),
        "lm_ca": cov,
        "lm_cd": cov.copy(),
        "lm_count": rng.integers(0, fill + 1, p).astype(np.int32),
    }
    if parity:   # asymmetric off-diagonals exercise the real cc plane
        st["lm_cb"] = rng.uniform(-0.005, 0.005, (l, p)).astype(np.float32)
        st["lm_cc"] = rng.uniform(-0.005, 0.005, (l, p)).astype(np.float32)
    else:        # production keeps cc == cb and stores no cc plane
        st["lm_cb"] = np.zeros((l, p), np.float32)
        st["lm_cc"] = None
    return st


def run_both(st, z, z_valid, jcfg):
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    want = jax_fused_update_planes(
        *(jnp.asarray(st[k]) if st[k] is not None else None
          for k in ("poses", "log_weights", *PLANES, "lm_count")),
        jnp.asarray(z), jnp.asarray(z_valid), jcfg, interpret=True,
    )
    t = {k: None if v is None else torch.from_numpy(v.copy()) for k, v in st.items()}
    got = cuda_kernels.fused_update_planes(
        t["poses"], t["log_weights"], *(t[k] for k in PLANES), t["lm_count"],
        torch.from_numpy(z), torch.from_numpy(z_valid), cfg,
    )
    return want, got


def assert_update_matches(want, got, parity):
    names = ("log_weights", *PLANES, "lm_count")
    for name, w, g in zip(names, want, got):
        if name == "lm_cc" and not parity:
            assert w is None and g is None
            continue
        if name == "lm_count":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def base_config(parity, p, l, m):
    return JaxConfig(num_particles=p, max_landmarks=l, max_measurements=m,
                     parity_mode=parity, use_pallas=True, pallas_interpret=True,
                     default_landmark_cov=0.125)


@pytest.mark.parametrize("parity", [False, True])
def test_fused_update_matches_jax(parity):
    """Matches, appends and an interior invalid measurement."""
    p, l, m = 256, 16, 8
    jcfg = base_config(parity, p, l, m)
    st = seeded_planes(p, l, seed=3, fill=10, parity=parity)
    rng = np.random.default_rng(4)
    z = np.zeros((m, 2), np.float32)
    z[:, 0] = rng.uniform(0.5, 5.0, m)
    z[:, 1] = rng.uniform(-3.0, 3.0, m)
    z_valid = np.array([1, 1, 0, 1, 1, 1, 0, 0], bool)   # interior hole
    want, got = run_both(st, z, z_valid, jcfg)
    assert_update_matches(want, got, parity)
    # the case exercised both updates and appends
    assert (got[-1].numpy() > st["lm_count"]).any()
    assert (np.asarray(want[0]) != st["log_weights"]).any()


@pytest.mark.parametrize("parity", [False, True])
def test_fused_update_full_capacity_drops_appends(parity):
    """Particles at capacity drop unmatched measurements."""
    p, l, m = 128, 8, 4
    jcfg = base_config(parity, p, l, m)
    st = seeded_planes(p, l, seed=5, fill=l, parity=parity)
    st["lm_count"][: p // 2] = l                         # half at capacity
    z = np.array([[2.0, 0.3], [9.0, 2.8], [7.5, -2.0], [1.0, 2.5]], np.float32)
    z_valid = np.ones(m, bool)
    want, got = run_both(st, z, z_valid, jcfg)
    assert_update_matches(want, got, parity)
    assert (got[-1].numpy()[: p // 2] == l).all()


def test_fused_update_empty_maps_append_then_match():
    """Empty maps: the first measurement appends, a nearby one matches it."""
    p, l, m = 128, 8, 4
    jcfg = base_config(False, p, l, m)
    st = seeded_planes(p, l, seed=6, fill=0, parity=False)
    z = np.array([[2.0, 0.0], [2.05, 0.01], [8.0, 2.8], [0.0, 0.0]], np.float32)
    z_valid = np.array([1, 1, 1, 0], bool)
    want, got = run_both(st, z, z_valid, jcfg)
    assert_update_matches(want, got, False)
    np.testing.assert_array_equal(got[-1].numpy(), np.full(p, 2, np.int32))


def test_cuda_wrapper_refuses_other_devices():
    """A tensor on a device without a kernel is refused, never computed."""
    cfg = config_from_jax_fields(dataclasses.asdict(base_config(False, 8, 4, 2)))
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_kernels.fused_update_planes(
            meta(8, 3), meta(8), *(meta(4, 8) for _ in range(4)), None,
            meta(4, 8), meta(8, dtype=torch.int32), meta(2, 2),
            meta(2, dtype=torch.bool), cfg,
        )
