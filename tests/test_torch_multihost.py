"""The sharded engine across processes: ``parallel/multihost.py`` and the
sharded steps over a gloo process group.

Mirrors ``tests/test_multihost.py`` with ``tests/multihost_worker.py``, and
the single-process helpers of ``tests/test_sharded.py:114-129``.  Two
processes on gloo hold 4 CPU shards each (an 8-shard mesh) and run the
worker's config (P = 32 x 2, L = 8, M = 4, rotation 0, translation 0.4, 5
blocks steps) on the draws of JAX's single-device step; then the blocks
step with the halo resampler, the per-tick planes fs2 step and the chunked
planes step (C = 4, motion and fs2), each with forced resamples
(``resample_threshold_frac=1``).  Every estimate and every gathered state
must be the same in both processes and bit for bit those of one process
with 8 shards; the 5-step trajectory within 1e-5 of JAX's single-device
step; each process holds 32 rows; the weights sum to 1 within 1e-5.

Then both distributed resamplers across the two processes: the halo
resampler and ``ring_halo_resample`` (the exchange kernel's plain version
over the group, as CPU shards take it) on healthy weights (the halo path)
and weights collapsed onto the last shard (the fallback).  Each must equal
``resample_state`` bit for bit in each worker, the ring's result one
process's at S = 8 bit for bit, and JAX's ``ring_halo_resample`` with its
``_ppermute_exchange`` on the 8 virtual CPU devices exactly in the indices
and counts and within 1e-6 in the floats (the data of
``tests/test_torch_ring_resample.py``, away from the resample grid).

The worker is this file run as a script (its ``__main__`` block), so it
imports no JAX; the parent gives it the JAX draws and the resampler's
states in a file.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.interop import filter_state_from_numpy
from fastslam_tpu_torch.core.state import (
    Measurements, init_planes_state, init_state, pad_measurements,
)
from fastslam_tpu_torch.parallel import collectives
from fastslam_tpu_torch.parallel.mesh import (
    make_mesh, shard_planes_state, shard_state, unshard,
)
from fastslam_tpu_torch.parallel.multihost import (
    initialize_distributed, local_shard, replicated_to_host,
)
from fastslam_tpu_torch.parallel.sharded import (
    make_sharded_planes_chunked_step, make_sharded_planes_step, make_sharded_step,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC, LOCAL_SHARDS = 2, 4
P, L, M, C = 32 * NPROC, 8, 4, 4
MS = [(2.0, 0.3), (3.5, -0.7)]
JAX_TICKS = 5
WORKER_TIMEOUT = 240   # seconds, each worker process
# the resamplers' weight profiles: their halo path, then their fallback
PROFILES = {"healthy": 1, "collapsed": 0}
RING_FIELDS = ("poses", "log_weights", "lm_mean", "lm_cov", "lm_count")


def ring_states(inputs):
    """The ring resampler's input states (numpy dicts, one per profile) as
    port states, and their offsets."""
    return {profile: (filter_state_from_numpy(st, "cpu"), torch.tensor(u0))
            for profile, (st, u0) in inputs.items()}


def run_rings(mesh, inputs):
    """``ring_halo_resample`` of each profile's state on ``mesh``: the
    gathered result's fields."""
    from fastslam_tpu_torch.parallel.ring_resample import ring_halo_resample

    cfg = config(parity_mode=False)
    out = {}
    for profile, (state, u0) in ring_states(inputs).items():
        got = unshard(ring_halo_resample(shard_state(state, mesh, cfg), u0, mesh, cfg), mesh)
        out[profile] = {k: getattr(got, k) for k in RING_FIELDS}
    return out


def config(**kw):
    return FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M, **kw)


SCENARIOS = {   # name: (layout, config changes, ticks or chunks)
    "blocks": ("blocks", {}, JAX_TICKS),
    "blocks halo": ("blocks", dict(parity_mode=False, distributed_resample=True,
                                   resample_threshold_frac=1.0), 3),
    "planes fs2": ("planes", dict(parity_mode=False, proposal_mode="fastslam2",
                                  resample_threshold_frac=1.0), 3),
    "chunked motion": ("chunked", dict(parity_mode=False, resample_threshold_frac=1.0), 2),
    "chunked fs2": ("chunked", dict(parity_mode=False, proposal_mode="fastslam2",
                                    resample_threshold_frac=1.0), 2),
}


def scenario_draws(name, jax_draws=None):
    """The global draws of each tick or chunk (the JAX step's for
    ``"blocks"``)."""
    layout, changes, n = SCENARIOS[name]
    if name == "blocks":
        return [kernels.Draws(**d) for d in jax_draws]
    gen = torch.Generator().manual_seed(len(name))
    fs2 = kernels.uses_fs2(config(**changes))
    return [kernels.draw(gen, P, C if layout == "chunked" else None, fs2=fs2) for _ in range(n)]


def run_scenario(name, mesh, draws):
    """One scenario on ``mesh`` from a fresh state: the estimates and this
    process's shards."""
    layout, changes, _ = SCENARIOS[name]
    cfg = config(**changes)
    ms = pad_measurements(cfg, MS, "cpu")
    if layout == "blocks":
        shards, step = shard_state(init_state(cfg, "cpu"), mesh, cfg), make_sharded_step(cfg, mesh)
    elif layout == "planes":
        shards = shard_planes_state(init_planes_state(cfg, "cpu"), mesh, cfg)
        step = make_sharded_planes_step(cfg, mesh)
    else:
        shards = shard_planes_state(init_planes_state(cfg, "cpu"), mesh, cfg)
        chunked = make_sharded_planes_chunked_step(cfg, mesh, C)
        ms = Measurements(ms.range_bearing.expand(C, -1, -1).contiguous(),
                          ms.valid.expand(C, -1).contiguous())
        step = lambda s, r, t, m, d: chunked(s, torch.zeros(C), torch.full((C,), 0.4), m, d)
    est = []
    for d in draws:
        shards, e = step(shards, 0.0, 0.4, ms, d)
        est.append(e.reshape(-1, 3))
    return torch.cat(est), shards


def run_all(mesh, jax_draws):
    """Every scenario on ``mesh``: per scenario its estimates, the gathered
    state's fields, and this process's rows and weight sum."""
    out = {}
    for name in SCENARIOS:
        est, shards = run_scenario(name, mesh, scenario_draws(name, jax_draws))
        state = unshard(shards, mesh)
        out[name] = {"est": est, "state": {k: v for k, v in state.__dict__.items()
                                           if v is not None},
                     "local_rows": int(local_shard([s.poses for s in shards]).shape[0]),
                     "weights_sum": float(np.exp(local_shard(
                         [s.log_weights for s in shards]).astype(np.float64)).sum())}
    return out


def worker(port: int, rank: int, nproc: int, outdir: str, mode: str) -> None:
    """One process of the two: the scenarios (``steps``), or the sharded
    checkpoint's save and load (``save``, ``load``; see
    ``tests/test_torch_sharded_checkpoint.py``)."""
    import torch.distributed as dist

    from fastslam_tpu_torch.parallel import dryrun

    info = initialize_distributed(f"localhost:{port}", nproc, rank)
    mesh = make_mesh(config(), ["cpu"] * LOCAL_SHARDS)
    result = {"info": info, "mesh": (mesh.process_index, mesh.num_processes,
                                     mesh.num_shards, mesh.row_offset)}
    if mode == "steps":
        result["runs"] = run_all(mesh, torch.load(os.path.join(outdir, "draws.pt")))
        cfg = config(parity_mode=False)
        result["rings"] = run_rings(mesh, torch.load(os.path.join(outdir, "rings.pt"),
                                                     weights_only=False))
        result["resamplers"] = {profile: dryrun.check_resamplers(
            cfg, None, "cpu", profile, 0.004, seed=3, mesh=mesh) for profile in PROFILES}
        result["traffic"] = dict(collectives.TRAFFIC)
    else:
        from tests.test_torch_sharded_checkpoint import checkpoint_worker

        result.update(checkpoint_worker(mesh, outdir, mode))
    torch.save(result, os.path.join(outdir, f"{mode}_{rank}.pt"))
    dist.barrier()     # no process leaves while the other still talks to it
    dist.destroy_process_group()
    # torch's destructors at interpreter exit sometimes abort a gloo process
    # under load ("terminate called without an active exception") after all
    # of its work is done and written: leave without running them
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(outdir, mode: str):
    """Run the two workers on a free local port; their results in rank
    order.  A worker that fails or outlives its timeout fails the test."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(i),
                               str(NPROC), str(outdir), mode],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(NPROC)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, (
                f"worker failed:\n{out.decode()[-2000:]}\n{err.decode()[-2000:]}")
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    return [torch.load(os.path.join(outdir, f"{mode}_{i}.pt"), weights_only=False)
            for i in range(NPROC)]


def test_multihost_utils_single_process():
    info = initialize_distributed()   # one process: no-op
    assert info == {"process_id": 0, "num_processes": 1, "local_devices": 1,
                    "global_devices": 1}
    cfg = config()
    mesh = make_mesh(cfg, ["cpu"] * 8)
    assert (mesh.process_index, mesh.num_processes, mesh.group) == (0, 1, None)
    shards = shard_state(init_state(cfg, "cpu"), mesh, cfg)
    poses = local_shard([s.poses for s in shards])
    assert poses.shape == (P, 3) and isinstance(poses, np.ndarray)
    weights = replicated_to_host(unshard(shards).log_weights)
    assert weights.shape == (P,)
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(num_processes=2, process_id=0)


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """The JAX single-device step's 5 ticks and draws; the scenarios in two
    gloo processes of 4 shards each, and in this process with 8 shards."""
    import jax
    import jax.numpy as jnp

    from fastslam_tpu.config import FastSLAMConfig as JaxConfig
    from fastslam_tpu.core import kernels as jax_kernels
    from fastslam_tpu.core.state import init_state as jax_init_state
    from fastslam_tpu.core.state import pad_measurements as jax_pad_measurements
    from tests.test_torch_ring_resample import U0, make_state
    from tests.test_torch_sharded import jax_draws as draws_of
    from tests.test_torch_step import assert_away_from_grid

    jcfg = JaxConfig(num_particles=P, max_landmarks=L, max_measurements=M)
    jms = jax_pad_measurements(jcfg, MS)
    jstep = jax.jit(lambda s: jax_kernels.fastslam_step(s, jnp.float32(0.0), jnp.float32(0.4),
                                                        jms, jcfg))
    js, draws, jax_poses = jax_init_state(jcfg, rng=0), [], []
    for _ in range(JAX_TICKS):
        draws.append(draws_of(js.rng, P, (P,), (P, 3))._asdict())
        js, pose = jstep(js)
        jax_poses.append(np.asarray(pose))
    outdir = tmp_path_factory.mktemp("multihost")
    torch.save(draws, outdir / "draws.pt")
    rings = {profile: (make_state(profile), U0[profile]) for profile in PROFILES}
    for st, u0 in rings.values():
        assert_away_from_grid(st["log_weights"], u0)
    torch.save(rings, outdir / "rings.pt")
    workers = spawn(outdir, "steps")
    mesh = make_mesh(config(), ["cpu"] * NPROC * LOCAL_SHARDS)
    one = run_all(mesh, draws)
    return {"jax_poses": np.stack(jax_poses), "workers": workers, "one": one,
            "rings": rings, "one_ring": run_rings(mesh, rings)}


@pytest.fixture(scope="module")
def jax_rings(two_processes):
    """JAX's ring resampler with its ppermute exchange on the 8 virtual CPU
    devices, on each profile's state (jitted once)."""
    import jax
    import jax.numpy as jnp

    from fastslam_tpu.config import FastSLAMConfig as JaxConfig
    from fastslam_tpu.core.state import FilterState as JaxFilterState
    from fastslam_tpu.parallel import mesh as jax_mesh
    from fastslam_tpu.parallel.ring_resample import _ppermute_exchange
    from fastslam_tpu.parallel.ring_resample import ring_halo_resample as jax_ring

    jcfg = JaxConfig(num_particles=P, max_landmarks=L, parity_mode=False)
    mesh = jax_mesh.make_mesh(jcfg, devices=jax.devices()[:NPROC * LOCAL_SHARDS])
    ring = jax.jit(lambda s, u: jax_ring(s, u, mesh, jcfg, _exchange=_ppermute_exchange))
    out = {}
    for profile, (st, u0) in two_processes["rings"].items():
        js = JaxFilterState(**{k: jnp.asarray(v) for k, v in st.items()},
                            rng=jax.random.key(0))
        got = ring(jax_mesh.shard_state(js, mesh, jcfg), jnp.float32(u0))
        out[profile] = {k: np.asarray(getattr(got, k)) for k in RING_FIELDS}
    return out


def test_two_processes_equal_one_bit_for_bit(two_processes):
    a, b = two_processes["workers"]
    assert a["info"] == {"process_id": 0, "num_processes": 2, "local_devices": 1,
                         "global_devices": 2}
    assert [w["mesh"] for w in (a, b)] == [(0, 2, 8, 0), (1, 2, 8, 4)]
    for name, want in two_processes["one"].items():
        for w in (a, b):
            got = w["runs"][name]
            assert torch.equal(got["est"], want["est"]), name
            assert got["state"].keys() == want["state"].keys()
            for k, v in want["state"].items():
                assert torch.equal(got["state"][k], v), (name, k)
    # the forced resamples ran: production weights back to uniform
    for name in SCENARIOS:
        lw = a["runs"][name]["state"]["log_weights"]
        assert name == "blocks" or bool((lw == lw[0]).all()), name


def test_two_processes_match_jax_and_hold_half(two_processes):
    a, b = two_processes["workers"]
    est = a["runs"]["blocks"]["est"].numpy()
    assert est.shape == (JAX_TICKS, 3) and np.isfinite(est).all()
    np.testing.assert_allclose(est, two_processes["jax_poses"], rtol=1e-5, atol=1e-5)
    for name in SCENARIOS:
        assert a["runs"][name]["local_rows"] == b["runs"][name]["local_rows"] == P // NPROC
        total = a["runs"][name]["weights_sum"] + b["runs"][name]["weights_sum"]
        assert total == pytest.approx(1.0, abs=1e-5), name


def test_two_processes_resample_across_the_group(two_processes):
    """Both resamplers across the processes equal ``resample_state`` bit for
    bit (checked in each worker) on their halo path and their fallback; the
    ring's exchange runs its plain version over the group (no kernel on the
    CPU); the ring's results equal the single-device resample bit for bit;
    the collectives count their traffic."""
    cfg = config(parity_mode=False)
    for w in two_processes["workers"]:
        assert w["resamplers"] == {p: {"ring_launches": 0, "peer_launches": 0, "halo_path": h}
                                   for p, h in PROFILES.items()}
        for profile, (state, u0) in ring_states(two_processes["rings"]).items():
            want = kernels.resample_state(
                state, kernels.systematic_resample_indices(torch.exp(state.log_weights), u0),
                cfg)
            for k in RING_FIELDS:
                assert torch.equal(w["rings"][profile][k], getattr(want, k)), (profile, k)
        assert w["traffic"]["calls"] > 0 and w["traffic"]["bytes"] > 0
        assert w["traffic"]["seconds"] > 0


@pytest.mark.parametrize("profile", list(PROFILES))
def test_two_processes_ring_equals_one_process_and_jax(two_processes, jax_rings, profile):
    """The ring resampler across the two processes: bit for bit one process
    at S = 8, and JAX's ring on 8 devices exactly in the indices and counts,
    within 1e-6 in the floats."""
    want = two_processes["one_ring"][profile]
    for w in two_processes["workers"]:
        got = w["rings"][profile]
        for k in RING_FIELDS:
            assert torch.equal(got[k], want[k]), k
            jax_value = jax_rings[profile][k]
            if k == "lm_count":
                np.testing.assert_array_equal(got[k].numpy(), jax_value)
            else:
                np.testing.assert_allclose(got[k].numpy(), jax_value, rtol=0, atol=1e-6,
                                           err_msg=k)


if __name__ == "__main__":
    port_, rank_, nproc_, outdir_, mode_ = sys.argv[1:6]
    worker(int(port_), int(rank_), int(nproc_), outdir_, mode_)
