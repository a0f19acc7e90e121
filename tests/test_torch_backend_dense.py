"""The port's DENSE distributed Schur step (``backend/distributed.py``,
``sparse=False``: the ``[K, L]`` Hpl assembly per shard) at S = 8 CPU shards
against JAX's on its 8-device virtual CPU mesh (``tests/conftest.py``; the
one JAX call on that mesh in this file), and against the port's S = 1 and
single-device steps.  Bars of ``tests/test_backend_distributed.py``: poses
within rtol = atol = 1e-4, landmarks within atol = 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

from fastslam_tpu.backend import distributed as jax_dist

from fastslam_tpu_torch.backend import distributed, pose_graph
from fastslam_tpu_torch.parallel.mesh import make_map_mesh
from tests.test_torch_backend_distributed import DAMP, make_graphs, sorted_rows

torch.set_num_threads(1)


def port_dense_step(g, shards):
    gs, dropped = distributed.shard_pose_graph(g, shards)
    assert dropped == 0
    step = distributed.make_sharded_gn_step(make_map_mesh(["cpu"] * shards), sparse=False)
    return step(gs, torch.tensor(DAMP))


def test_dense_step_at_8_shards_matches_jax_mesh():
    gj, gt_, _ = make_graphs()
    devs = np.asarray(jax.devices())
    assert len(devs) == 8, "conftest should provide 8 virtual devices"
    g8, _ = jax_dist.shard_pose_graph(gj, 8)
    step = jax_dist.make_sharded_gn_step(Mesh(devs, ("map",)), sparse=False)
    p_want, l_want = step(g8, jnp.float32(DAMP))
    p_got, l_got = port_dense_step(gt_, 8)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sorted_rows(l_got.numpy()), sorted_rows(l_want), atol=1e-3)


def test_dense_step_8_shards_vs_1_and_single_device():
    _, gt_, _ = make_graphs(seed=5, k=16, drift=0.5)
    p_one, l_one = pose_graph.gauss_newton_step(gt_.poses, gt_.landmarks, gt_, DAMP)
    for shards in (8, 1):
        p, l = port_dense_step(gt_, shards)
        np.testing.assert_allclose(p.numpy(), p_one.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(l.numpy(), l_one.numpy(), atol=1e-3)
