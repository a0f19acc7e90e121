"""The sharded checkpoint (``io/sharded_checkpoint.py``): save and load a
state on a particle mesh, in one process and across two.

Mirrors ``tests/test_orbax_checkpoint.py:20,51``: a planes round trip that
restores a non-trivial state bit for bit, with its iteration, robot pose and
generator (the next draws equal); a blocks round trip with the layout guard
(JAX's message); and here also the version guard, a mesh of another shard
count refused, a 2-D mesh, the payload's names against JAX's
``_to_payload``, and a save by two gloo processes (4 shards each) that
loads back in two fresh processes bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core.state import init_planes_state, init_state
from fastslam_tpu_torch.io import sharded_checkpoint
from fastslam_tpu_torch.io.sharded_checkpoint import (
    load_sharded_checkpoint, save_sharded_checkpoint,
)
from fastslam_tpu_torch.parallel.mesh import (
    make_mesh, shard_planes_state, shard_state, unshard,
)

torch.set_num_threads(1)

CFG = FastSLAMConfig(num_particles=128, max_landmarks=8, max_measurements=4)


def assert_same(got, want):
    for k, v in want.__dict__.items():
        g = getattr(got, k)
        assert (v is None and g is None) or torch.equal(g, v), k


def nontrivial_blocks(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    p, l = cfg.num_particles, cfg.max_landmarks
    return init_state(cfg, "cpu").replace(
        poses=torch.randn(p, 3, generator=gen), log_weights=torch.randn(p, generator=gen),
        lm_mean=torch.randn(p, l, 2, generator=gen), lm_cov=torch.rand(p, l, 4, generator=gen),
        lm_count=torch.randint(0, l + 1, (p,), generator=gen, dtype=torch.int32))


def test_sharded_planes_roundtrip(tmp_path):
    mesh = make_mesh(CFG, ["cpu"] * 8)
    st = init_planes_state(CFG, "cpu")
    st = st.replace(poses=st.poses + 1.5, lm_mx=st.lm_mx.index_fill(0, torch.tensor([0]), 2.0),
                    lm_count=st.lm_count + 1)
    gen = torch.Generator().manual_seed(3)
    torch.randn(5, generator=gen)
    path = str(tmp_path / "ckpt")
    save_sharded_checkpoint(path, shard_planes_state(st, mesh, CFG), mesh=mesh, iteration=42,
                            robot_pose=[1.0, 2.0, 0.3], generator=gen)
    template = shard_planes_state(init_planes_state(CFG, "cpu"), mesh, CFG)
    got, meta = load_sharded_checkpoint(path, template, mesh=mesh)
    assert meta["iteration"] == 42
    np.testing.assert_array_equal(meta["robot_pose"], np.float64([1.0, 2.0, 0.3]))
    assert len(got) == 8 and got[0].lm_mx.shape == (8, 16)
    assert all(g.lm_mx.device == t.lm_mx.device for g, t in zip(got, template))
    assert_same(unshard(got), st)
    # the generator's stream continues where it was saved
    assert torch.equal(torch.randn(4, generator=meta["generator"]), torch.randn(4, generator=gen))
    # the template is not written
    assert float(template[0].poses.abs().sum()) == 0.0


def test_blocks_roundtrip_and_guards(tmp_path, monkeypatch):
    mesh = make_mesh(CFG, ["cpu"] * 8)
    st = nontrivial_blocks(CFG, 1)
    path = str(tmp_path / "ckpt_blocks")
    save_sharded_checkpoint(path, shard_state(st, mesh, CFG), mesh=mesh, iteration=7)
    got, meta = load_sharded_checkpoint(path, shard_state(init_state(CFG, "cpu"), mesh, CFG),
                                        mesh=mesh)
    assert meta["iteration"] == 7 and meta["generator"] is None
    np.testing.assert_array_equal(meta["robot_pose"], np.zeros(3))
    assert_same(unshard(got), st)
    # a blocks checkpoint into a planes template: JAX's message
    with pytest.raises(ValueError, match="saved blocks, template planes"):
        load_sharded_checkpoint(path, shard_planes_state(init_planes_state(CFG, "cpu"), mesh,
                                                         CFG), mesh=mesh)
    # a template of another shard count
    mesh4 = make_mesh(CFG, ["cpu"] * 4)
    with pytest.raises(ValueError, match="holds 8 shards in 8 particle rows"):
        load_sharded_checkpoint(path, shard_state(init_state(CFG, "cpu"), mesh4, CFG),
                                mesh=mesh4)
    # another format version
    monkeypatch.setattr(sharded_checkpoint, "_FORMAT_VERSION", 2)
    save_sharded_checkpoint(path, shard_state(st, mesh, CFG), mesh=mesh)
    monkeypatch.setattr(sharded_checkpoint, "_FORMAT_VERSION", 1)
    with pytest.raises(ValueError, match="unsupported checkpoint version 2"):
        load_sharded_checkpoint(path, shard_state(init_state(CFG, "cpu"), mesh, CFG), mesh=mesh)


def test_2d_mesh_roundtrip(tmp_path):
    """A 4 x 2 mesh: a row's poses, weights and counts written once, and
    shared again by the row's shards after the load; a 1-D template of the
    same shard count is refused."""
    mesh = make_mesh(CFG, ["cpu"] * 8, map_parallelism=2)
    st = nontrivial_blocks(CFG, 2)
    path = str(tmp_path / "ckpt_2d")
    save_sharded_checkpoint(path, shard_state(st, mesh, CFG), mesh=mesh)
    got, _ = load_sharded_checkpoint(path, shard_state(init_state(CFG, "cpu"), mesh, CFG),
                                     mesh=mesh)
    assert got[2].poses is got[3].poses and got[2].lm_mean.shape == (32, 4, 2)
    assert_same(unshard(got, mesh), st)
    mesh1 = make_mesh(CFG, ["cpu"] * 8)
    with pytest.raises(ValueError, match="holds 8 shards in 4 particle rows"):
        load_sharded_checkpoint(path, shard_state(init_state(CFG, "cpu"), mesh1, CFG),
                                mesh=mesh1)


@pytest.mark.parametrize("planes", [False, True])
def test_payload_names_match_jax(planes):
    """The keys written: the JAX payload's, a field per shard, plus the
    generator's state."""
    import jax

    from fastslam_tpu.config import FastSLAMConfig as JaxConfig
    from fastslam_tpu.core.state import init_planes_state as jax_init_planes_state
    from fastslam_tpu.core.state import init_state as jax_init_state
    from fastslam_tpu.io.orbax_checkpoint import _to_payload

    jcfg = JaxConfig(num_particles=128, max_landmarks=8, max_measurements=4, parity_mode=False)
    jstate = (jax_init_planes_state if planes else jax_init_state)(jcfg, rng=0)
    want = set(_to_payload(jstate, 0, None)) | {"torch_generator_state"}
    cfg = CFG.replace(parity_mode=False)
    mesh = make_mesh(cfg, ["cpu"] * 2)
    shards = (shard_planes_state(init_planes_state(cfg, "cpu"), mesh, cfg) if planes
              else shard_state(init_state(cfg, "cpu"), mesh, cfg))
    keys = set(sharded_checkpoint._header(0, None, torch.Generator(), planes))
    for ks in sharded_checkpoint._shard_keys(shards, mesh):
        keys |= {key.split("/")[0] for key in ks.values()}
    assert keys == want
    assert jax.random.key_data(jstate.rng).shape == (2,)


def checkpoint_worker(mesh, outdir: str, mode: str) -> dict:
    """In a worker of ``tests/test_torch_multihost.py``: save a state
    stepped by the 8-shard mesh over both processes, with its generator
    (``save``), or load it into a fresh template (``load``).  Returns the
    gathered state and the generator's next draws."""
    from fastslam_tpu_torch.core import kernels
    from fastslam_tpu_torch.core.state import pad_measurements
    from fastslam_tpu_torch.parallel.sharded import make_sharded_step

    cfg = mesh_config(mesh)
    path = os.path.join(outdir, "ckpt")
    if mode == "save":
        gen = torch.Generator().manual_seed(11)
        shards, step = shard_state(init_state(cfg, "cpu"), mesh, cfg), make_sharded_step(cfg, mesh)
        ms = pad_measurements(cfg, [(2.0, 0.3), (3.5, -0.7)], "cpu")
        for _ in range(3):
            shards, _ = step(shards, 0.0, 0.4, ms, kernels.draw(gen, cfg.num_particles))
        save_sharded_checkpoint(path, shards, mesh=mesh, iteration=3, robot_pose=[1.2, 0, 0],
                                generator=gen)
        meta = {"iteration": 3, "generator": gen}
    else:
        shards, meta = load_sharded_checkpoint(
            path, shard_state(init_state(cfg, "cpu"), mesh, cfg), mesh=mesh)
    state = unshard(shards, mesh)
    return {"state": state.__dict__, "iteration": meta["iteration"],
            "next_draws": torch.randn(8, generator=meta["generator"]),
            "local_keys": len(shards)}


def mesh_config(mesh):
    return FastSLAMConfig(num_particles=16 * mesh.num_shards, max_landmarks=8,
                          max_measurements=4, parity_mode=False)


def test_two_process_save_loads_in_two_fresh_processes(tmp_path):
    from tests.test_torch_multihost import spawn

    saved = spawn(tmp_path, "save")
    loaded = spawn(tmp_path, "load")
    files = os.listdir(tmp_path / "ckpt")
    assert {"__0_0.distcp", "__1_0.distcp", ".metadata"} <= set(files)
    for s, l in zip(saved, loaded):
        assert l["iteration"] == 3 and l["local_keys"] == 4
        assert torch.equal(l["next_draws"], s["next_draws"])
        for k, v in saved[0]["state"].items():
            assert torch.equal(l["state"][k], v), k
    assert int(saved[0]["state"]["lm_count"].min()) >= 2
