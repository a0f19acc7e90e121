"""The port's plain chunked FastSLAM 2.0 update against the JAX Pallas kernel
(``fused_fs2_planes_multi``, interpret mode): C in {1, 4}, rotation and
translation ticks, per-tick ``[C]`` floors and mode dial, both weightings.
Trajectories at 1e-4, planes at 2e-5, counts exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.core.pallas_kernels import (
    fused_fs2_planes_multi as jax_fused_fs2_planes_multi,
)

from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.interop import config_from_jax_fields
from tests.test_torch_fused_fs2 import (
    FS2_PLANES, fs2_config, mapped_state, observe, prior_scalars,
)

torch.set_num_threads(1)


def chunk_inputs(c, m, p, world, seed):
    """Alternating translation and rotation ticks; per tick, measurements of
    mapped landmarks from the true pose the odometry reaches (plus an
    unmapped corner, appended on tick 0 and matched after; an interior hole
    on tick 0, none on the last tick of a long chunk), and the draws."""
    rng = np.random.default_rng(seed)
    rotating = np.arange(c) % 2 == 1
    rots = np.where(rotating, 0.05, 0.0).astype(np.float32)
    trans = np.where(rotating, 0.0, 0.02).astype(np.float32)
    z = np.zeros((c, m, 2), np.float32)
    z_valid = np.zeros((c, m), bool)
    pose = np.zeros(3)
    corner = np.array([-6.0, -3.5])
    for k in range(c):
        pose[2] += rots[k]
        pose[:2] += trans[k] * np.array([np.cos(pose[2]), np.sin(pose[2])])
        rel = np.concatenate([world, corner[None]]) - pose[:2]
        robot = np.stack([rel[:, 0] * np.cos(pose[2]) + rel[:, 1] * np.sin(pose[2]),
                          -rel[:, 0] * np.sin(pose[2]) + rel[:, 1] * np.cos(pose[2])], -1)
        n = int(rng.integers(2, m))
        seen = observe(robot, rng.permutation(len(world))[: n - 1], rng,
                       extra=[(np.hypot(*robot[-1]), np.arctan2(robot[-1, 1], robot[-1, 0]))])
        z[k, :n] = seen
        z_valid[k, :n] = True
    z_valid[0, 1] = False
    if c > 2:
        z_valid[-1] = False
    noise = rng.standard_normal((c, 3, p)).astype(np.float32)
    return z, z_valid, rots, trans, noise


@pytest.mark.parametrize("c,evidence", [(1, False), (4, False), (4, True)])
def test_fused_fs2_multi_matches_jax(c, evidence):
    p, l, m = 256, 16, 8
    jcfg = fs2_config(p, l, m, evidence)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    st, world = mapped_state(p, l, seed=51, fill=10)
    z, z_valid, rots, trans, noise = chunk_inputs(c, m, p, world, seed=52)
    floors = (np.linspace(0.005, 0.02, c).astype(np.float32),
              np.linspace(0.01, 0.004, c).astype(np.float32))
    s_t2, s_r2, fxy = prior_scalars(jcfg, rots, trans, floors)
    dial = np.where(np.arange(c) % 3 == 1, 0.37, 1.0).astype(np.float32)
    args = (noise, rots, trans, s_t2, s_r2, fxy)

    want = jax_fused_fs2_planes_multi(
        *(jnp.asarray(st[k]) for k in ("poses", "log_weights", *FS2_PLANES[:4])),
        None, jnp.asarray(st["lm_cd"]), jnp.asarray(st["lm_count"]),
        jnp.asarray(z), jnp.asarray(z_valid), *(jnp.asarray(a) for a in args),
        jcfg, evidence_scale=jnp.asarray(dial), interpret=True,
    )
    t = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    got = cuda_kernels.fused_fs2_planes_multi(
        *(t[k] for k in ("poses", "log_weights", *FS2_PLANES[:4])), None,
        t["lm_cd"], t["lm_count"], torch.from_numpy(z), torch.from_numpy(z_valid),
        *(torch.tensor(a) for a in args), cfg, evidence_scale=torch.from_numpy(dial),
    )

    for name, w, g in zip(("tx", "ty", "tyaw", "tlogw"), want[:4], got[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert want[8] is None and got[8] is None            # no cc plane
    for name, w, g in zip(FS2_PLANES, want[4:8] + want[9:10], got[4:8] + got[9:10]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(got[10].numpy(), np.asarray(want[10]))
    # appends and weight updates happened across the chunk
    assert (got[10].numpy() > st["lm_count"]).any()
    assert (got[3][-1].numpy() != st["log_weights"]).any()
    # the input poses and weights are read only
    np.testing.assert_array_equal(t["poses"].numpy(), st["poses"])
    np.testing.assert_array_equal(t["log_weights"].numpy(), st["log_weights"])
