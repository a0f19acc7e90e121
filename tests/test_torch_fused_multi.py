"""The port's plain chunked update against the JAX Pallas kernel (interpret
mode), production, C=4 ticks: planes at 1e-5, per-tick trajectories at 1e-4
(the bars of ``tests/test_pallas.py``'s chunked test), counts exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.core.pallas_kernels import (
    fused_update_planes_multi as jax_fused_update_planes_multi,
)

from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.interop import config_from_jax_fields
from tests.test_torch_fused_update import PLANES, base_config, seeded_planes

torch.set_num_threads(1)


def chunk_inputs(c, m, p, seed):
    """Per-tick measurements (updates, appends, an interior hole, padded
    slots) and rotation-XOR-translation motion increments."""
    rng = np.random.default_rng(seed)
    z = np.zeros((c, m, 2), np.float32)
    z[..., 0] = rng.uniform(0.5, 6.0, (c, m))
    z[..., 1] = rng.uniform(-3.0, 3.0, (c, m))
    z_valid = np.zeros((c, m), bool)
    for k in range(c):
        z_valid[k, : rng.integers(1, m + 1)] = True
    z_valid[0, 1] = False
    rotating = np.arange(c) % 2 == 1
    noisy_rot = np.where(rotating[:, None], rng.normal(0.3, 0.01, (c, p)),
                         0.0).astype(np.float32)
    noisy_trans = np.where(rotating[:, None], 0.0,
                           rng.normal(0.4, 0.01, (c, p))).astype(np.float32)
    return z, z_valid, noisy_rot, noisy_trans


@pytest.mark.parametrize("c", [1, 4])
def test_fused_multi_matches_jax(c):
    p, l, m = 256, 16, 8
    jcfg = base_config(False, p, l, m)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    st = seeded_planes(p, l, seed=11, fill=6, parity=False)
    z, z_valid, noisy_rot, noisy_trans = chunk_inputs(c, m, p, seed=12)

    want = jax_fused_update_planes_multi(
        *(jnp.asarray(st[k]) if st[k] is not None else None
          for k in ("poses", "log_weights", *PLANES, "lm_count")),
        jnp.asarray(z), jnp.asarray(z_valid), jnp.asarray(noisy_rot),
        jnp.asarray(noisy_trans), jcfg, interpret=True,
    )
    t = {k: None if v is None else torch.from_numpy(v.copy()) for k, v in st.items()}
    got = cuda_kernels.fused_update_planes_multi(
        t["poses"], t["log_weights"], *(t[k] for k in PLANES), t["lm_count"],
        torch.from_numpy(z), torch.from_numpy(z_valid),
        torch.from_numpy(noisy_rot), torch.from_numpy(noisy_trans), cfg,
    )

    for name, w, g in zip(("tx", "ty", "tyaw", "tlogw"), want[:4], got[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for name, w, g in zip(PLANES, want[4:10], got[4:10]):
        if name == "lm_cc":
            assert w is None and g is None   # production: no cc plane
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[10].numpy(), np.asarray(want[10]))
    # appends and EKF updates both happened across the chunk
    assert (got[10].numpy() > st["lm_count"]).any()
    assert (got[3][-1].numpy() != st["log_weights"]).any()
    # the input poses and weights are read only
    np.testing.assert_array_equal(t["poses"].numpy(), st["poses"])
    np.testing.assert_array_equal(t["log_weights"].numpy(), st["log_weights"])
