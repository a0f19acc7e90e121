"""The port's IO and production hooks against the JAX package's, on the CPU.

* ``serialize_tick`` writes the same file text as JAX's for the same numpy
  inputs; ``TrajectoryLogger`` and ``MetricsLog`` the same records.
* A JAX checkpoint, in either layout, loads in the port with equal arrays;
  a port checkpoint round-trips, and its generator continues the stream.
* ``dbscan_clusters`` equals JAX's on point sets with core, border and
  noise points: labels and representatives exactly, centroids within 1e-6
  (the port sums each cluster over a dense membership mask, JAX scatters).
* ``cluster_known_landmarks`` equals JAX's on a state carried over as numpy.
* ``HealthMonitor.check`` gives JAX's issues and Neff (within 1e-9
  relative: the float64 sums add in another order) on healthy, degenerate,
  NaN-poisoned and near-full states; both ``recover`` branches.
* ``run_driver`` with every hook on against JAX's on the 60-tick seed-9
  drive (without motion noise both loops are deterministic, whatever their
  draws): the same snapshots, tick records and checkpoint ticks; and with
  the hooks on against off, bit for bit.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.app import runner as jax_runner
from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.core.state import init_planes_state as jax_init_planes_state
from fastslam_tpu.core.state import init_state as jax_init_state
from fastslam_tpu.drivers.replay import ReplayDriver as JaxReplayDriver
from fastslam_tpu.drivers.replay import record_log as jax_record_log
from fastslam_tpu.drivers.sim_world import SimWorld as JaxSimWorld
from fastslam_tpu.frontend.clustering import dbscan_clusters as jax_dbscan
from fastslam_tpu.frontend.global_map import cluster_known_landmarks as jax_cluster
from fastslam_tpu.io import checkpoint as jax_checkpoint
from fastslam_tpu.io import serializer as jax_serializer
from fastslam_tpu.utils.health import HealthMonitor as JaxHealthMonitor
from fastslam_tpu.utils.logging_utils import MetricsLog as JaxMetricsLog

from fastslam_tpu_torch.app import runner
from fastslam_tpu_torch.app.runner import SLAMRunner, run_driver
from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import (
    FilterState, PlanesState, init_planes_state, init_state, to_planes,
)
from fastslam_tpu_torch.drivers.replay import ReplayDriver, record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.frontend.clustering import dbscan_clusters
from fastslam_tpu_torch.frontend.global_map import cluster_known_landmarks
from fastslam_tpu_torch.interop import config_from_jax_fields, filter_state_from_numpy
from fastslam_tpu_torch.io import checkpoint, serializer
from fastslam_tpu_torch.utils.health import HealthMonitor
from fastslam_tpu_torch.utils.logging_utils import MetricsLog

torch.set_num_threads(1)


def port_config(jcfg):
    return config_from_jax_fields(dataclasses.asdict(jcfg))


# ---------------------------------------------------------------- serializer

SNAPSHOTS = {
    "small": ((1.0, 2.0, 0.5), (1.1, 2.1, 0.6), np.array([[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]]),
              [(3.0, 4.0), (-1.25, 0.5)], {"distance": 0.14, "angle_diff": -0.01}),
    "subsampled": ((0.0, 0.0, 0.0), (0.1, -0.2, 3.0),
                   np.random.default_rng(4).normal(size=(2000, 3)).astype(np.float32),
                   [], None),
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_serialize_tick_writes_the_same_text_as_jax(tmp_path, name):
    args = SNAPSHOTS[name]
    jax_serializer.serialize_tick(*args, path=str(tmp_path / "jax" / "s.json"))
    serializer.serialize_tick(*args, path=str(tmp_path / "port" / "s.json"))
    text = (tmp_path / "port" / "s.json").read_text()
    assert text == (tmp_path / "jax" / "s.json").read_text()
    snap = serializer.deserialize_tick(str(tmp_path / "port" / "s.json"))
    assert snap == jax_serializer.deserialize_tick(str(tmp_path / "port" / "s.json"))
    assert len(snap["particles"]) == min(len(args[2]), 500)


def test_deserialize_tolerates_missing_and_torn_files(tmp_path):
    assert serializer.deserialize_tick(str(tmp_path / "nope.json")) is None
    (tmp_path / "torn.json").write_text("{ torn write")
    assert serializer.deserialize_tick(str(tmp_path / "torn.json")) is None


def test_trajectory_and_metrics_logs_write_jax_records(tmp_path):
    for mod, tag in ((jax_serializer, "jax"), (serializer, "port")):
        log = mod.TrajectoryLogger(str(tmp_path / tag / "traj.jsonl"))
        log.log(3, (1.0, 2.0, 0.1), np.array([1.0, 2.5, 0.2]), {"neff": 12.5})
        log.close()
    assert ((tmp_path / "port" / "traj.jsonl").read_text()
            == (tmp_path / "jax" / "traj.jsonl").read_text())
    records = {}
    for cls, tag in ((JaxMetricsLog, "jax"), (MetricsLog, "port")):
        m = cls(str(tmp_path / tag / "m.jsonl"))
        m.write("tick", tick=4, distance=0.25, num_measurements=3)
        m.write("health", tick=5, issues=["estimate_jump"])
        m.close()
        records[tag] = [json.loads(l) for l in open(tmp_path / tag / "m.jsonl")]
        for r in records[tag]:
            assert r.pop("t") > 0
    assert records["port"] == records["jax"]


# ---------------------------------------------------------------- checkpoint

def jax_blocks_state():
    st = jax_init_state(JaxConfig(num_particles=16, max_landmarks=4), rng=3)
    rng = np.random.default_rng(5)
    return st._replace(
        poses=jnp.asarray(rng.normal(size=(16, 3)), jnp.float32),
        lm_count=jnp.asarray(rng.integers(0, 5, 16), jnp.int32),
        lm_mean=jnp.asarray(rng.normal(size=(16, 4, 2)), jnp.float32),
        lm_cov=jnp.asarray(rng.normal(size=(16, 4, 4)), jnp.float32))


def jax_planes_state(parity):
    cfg = JaxConfig(num_particles=128, max_landmarks=8, parity_mode=parity,
                    use_pallas=True, pallas_interpret=True)
    st = jax_init_planes_state(cfg, rng=3)
    rng = np.random.default_rng(6)
    planes = {f: jnp.asarray(rng.normal(size=(8, 128)), jnp.float32)
              for f in ("lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cd")}
    if parity:
        planes["lm_cc"] = jnp.asarray(rng.normal(size=(8, 128)), jnp.float32)
    return st._replace(lm_count=jnp.asarray(rng.integers(0, 9, 128), jnp.int32), **planes)


@pytest.mark.parametrize("layout", ["blocks", "planes production", "planes parity"])
def test_a_jax_checkpoint_loads_in_the_port(tmp_path, layout):
    st = jax_blocks_state() if layout == "blocks" else jax_planes_state("parity" in layout)
    path = str(tmp_path / "ck.npz")
    jax_checkpoint.save_checkpoint(path, st, iteration=42, robot_pose=np.array([1, 2, 0.3]),
                                   extra={"note": np.arange(3)})
    got, meta = checkpoint.load_checkpoint(path, "cpu")
    assert isinstance(got, FilterState if layout == "blocks" else PlanesState)
    assert meta["iteration"] == 42
    np.testing.assert_array_equal(meta["robot_pose"], [1, 2, 0.3])
    np.testing.assert_array_equal(meta["extra"]["note"], np.arange(3))
    assert isinstance(meta["generator"], torch.Generator)
    for name, want in st._asdict().items():
        if name == "rng":
            continue
        have = getattr(got, name)
        if want is None:
            assert have is None, name
        else:
            assert have.dtype == (torch.int32 if name == "lm_count" else torch.float32)
            np.testing.assert_array_equal(have.numpy(), np.asarray(want), err_msg=name)


def port_states():
    cfg = JaxConfig(num_particles=32, max_landmarks=4, max_measurements=4,
                    parity_mode=False)
    cfg = port_config(cfg)
    state = init_state(cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    ms = kernels.Measurements(torch.tensor([[2.0, 0.3], [3.5, -0.7], [0.0, 0.0],
                                            [0.0, 0.0]]),
                              torch.tensor([True, True, False, False]))
    state, _ = kernels.fastslam_step(state, 0.0, 0.4, ms, cfg, kernels.draw(gen, 32))
    return {"blocks": state, "planes": to_planes(state, cfg)}


@pytest.mark.parametrize("layout", ["blocks", "planes"])
def test_a_port_checkpoint_round_trips_with_its_generator(tmp_path, layout):
    state = port_states()[layout]
    gen = torch.Generator().manual_seed(11)
    torch.randn(5, generator=gen)
    path = str(tmp_path / "sub" / "ck.npz")
    checkpoint.save_checkpoint(path, state, iteration=7, robot_pose=np.array([0.5, 0, 0]),
                               generator=gen)
    want_draws = torch.randn(8, generator=gen)
    got, meta = checkpoint.load_checkpoint(path, "cpu")
    assert type(got) is type(state) and meta["iteration"] == 7
    for name, v in state.__dict__.items():
        if v is None:
            assert getattr(got, name) is None
        else:
            assert torch.equal(getattr(got, name), v), name
    assert torch.equal(torch.randn(8, generator=meta["generator"]), want_draws)
    assert not list((tmp_path / "sub").glob("*.tmp"))   # the write was atomic


def test_a_jax_checkpoint_seeds_a_generator_from_its_key(tmp_path):
    path = str(tmp_path / "ck.npz")
    jax_checkpoint.save_checkpoint(path, jax_blocks_state())
    a = torch.randn(4, generator=checkpoint.load_checkpoint(path, "cpu")[1]["generator"])
    b = torch.randn(4, generator=checkpoint.load_checkpoint(path, "cpu")[1]["generator"])
    assert torch.equal(a, b)


def test_a_checkpoint_of_another_version_is_refused(tmp_path):
    path = str(tmp_path / "ck.npz")
    np.savez(path, format_version=np.int32(2))
    with pytest.raises(ValueError, match="version"):
        checkpoint.load_checkpoint(path, "cpu")


# ---------------------------------------------------------------- clustering

def clustered_points(seed):
    """Two dense blobs, a chain of sparse points leading off one of them
    (border points), scattered noise and a few invalid points."""
    rng = np.random.default_rng(seed)
    blobs = [rng.normal(c, 0.12, (12, 2)) for c in ((0, 0), (3, 1))]
    chain = np.stack([np.linspace(0.45, 0.9, 3), np.zeros(3)], -1)
    noise = rng.uniform(-6, 6, (10, 2))
    pts = np.concatenate(blobs + [chain, noise]).astype(np.float32)
    valid = rng.random(len(pts)) < 0.95
    return pts, valid


@pytest.mark.parametrize("seed,min_samples", [(0, 2), (0, 4), (1, 3), (1, 6), (2, 5),
                                              (2, 40)])
def test_dbscan_matches_jax(seed, min_samples):
    pts, valid = clustered_points(seed)
    want = jax_dbscan(jnp.asarray(pts), jnp.asarray(valid), 0.5, jnp.int32(min_samples))
    got = dbscan_clusters(torch.from_numpy(pts), torch.from_numpy(valid), 0.5,
                          torch.tensor(min_samples, dtype=torch.int32))
    np.testing.assert_array_equal(got.label.numpy(), np.asarray(want.label))
    np.testing.assert_array_equal(got.is_rep.numpy(), np.asarray(want.is_rep))
    np.testing.assert_allclose(got.centroid.numpy(), np.asarray(want.centroid), atol=1e-6)
    if min_samples < 40:
        noise = got.label.numpy() == len(pts)
        assert noise.any() and (~noise).any()


def test_dbscan_finds_border_points():
    pts = np.array([[0, 0], [0.1, 0], [0.2, 0], [0.6, 0], [3, 3]], np.float32)
    got = dbscan_clusters(torch.from_numpy(pts), torch.ones(5, dtype=torch.bool), 0.5,
                          torch.tensor(3))
    # 0-2 are core, 3 borders 2 (2 neighbours of its own), 4 is noise
    assert got.label.tolist() == [0, 0, 0, 0, 5]
    assert got.is_rep.tolist() == [True, False, False, False, False]
    np.testing.assert_allclose(got.centroid[0].numpy(), [0.225, 0.0], atol=1e-7)


def landmark_state(seed, p=64, l=8):
    """A blocks state whose particles saw the same few landmarks, each with
    its own small error, and counts between 2 and L."""
    rng = np.random.default_rng(seed)
    truth = rng.uniform(-5, 5, (l, 2))
    return {"poses": rng.normal(size=(p, 3)).astype(np.float32),
            "log_weights": np.full(p, -np.log(p), np.float32),
            "lm_mean": (truth[None] + rng.normal(0, 0.05, (p, l, 2))).astype(np.float32),
            "lm_cov": np.tile(np.array([0.1, 0, 0, 0.1], np.float32), (p, l, 1)),
            "lm_count": rng.integers(2, l + 1, p).astype(np.int32)}


@pytest.mark.parametrize("seed,p", [(0, 64), (1, 20), (2, 100)])
def test_cluster_known_landmarks_matches_jax(seed, p):
    arrays = landmark_state(seed, p)
    jcfg = JaxConfig(num_particles=p, max_landmarks=8)
    jstate = jax_init_state(jcfg, rng=0)._replace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want_c, want_ok = jax_cluster(jstate, jcfg)
    got_c, got_ok = cluster_known_landmarks(filter_state_from_numpy(arrays, "cpu"),
                                            port_config(jcfg))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert got_ok.sum() > 1
    np.testing.assert_allclose(got_c.numpy()[got_ok.numpy()],
                               np.asarray(want_c)[np.asarray(want_ok)], atol=1e-6)


def test_cluster_known_landmarks_is_empty_below_one_sample():
    arrays = landmark_state(3, 40)
    arrays["lm_count"][:] = 1          # 0.7 * 1 landmark per particle < 1
    got_c, got_ok = cluster_known_landmarks(filter_state_from_numpy(arrays, "cpu"),
                                            port_config(JaxConfig(num_particles=40)))
    assert not got_ok.any()


# ---------------------------------------------------------------- health

def health_states():
    rng = np.random.default_rng(8)
    p, l = 50, 8
    base = landmark_state(8, p, l)
    healthy = dict(base, log_weights=np.log(rng.dirichlet(np.ones(p))).astype(np.float32))
    degenerate = dict(base, log_weights=np.where(np.arange(p) == 3, 0.0, -60.0)
                      .astype(np.float32))
    poisoned = dict(healthy, log_weights=np.where(np.arange(p) == 7, np.nan,
                                                  healthy["log_weights"]).astype(np.float32))
    full = dict(healthy, lm_count=np.full(p, l, np.int32))
    return {"healthy": healthy, "degenerate": degenerate, "poisoned": poisoned,
            "full": full}


SEQUENCES = {   # (state, pose) per tick, checked in order by one monitor each
    "healthy": [("healthy", (0, 0, 0)), ("healthy", (0.2, 0.1, 0.0))],
    "degenerate": [("degenerate", (0, 0, 0))] * 22,
    "poisoned": [("healthy", (0, 0, 0)), ("poisoned", (0.1, 0, 0)),
                 ("healthy", (np.nan, 0, 0)), ("healthy", (0.1, 0, 0))],
    "full and jumping": [("full", (0, 0, 0)), ("full", (2.0, 0.5, 0.1))],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_health_check_matches_jax(name):
    states = health_states()
    jcfg = JaxConfig(num_particles=50, max_landmarks=8)
    want_m, got_m = JaxHealthMonitor(jcfg), HealthMonitor(port_config(jcfg))
    seen = set()
    for key, pose in SEQUENCES[name]:
        arrays = states[key]
        jstate = jax_init_state(jcfg, rng=0)._replace(
            **{k: jnp.asarray(v) for k, v in arrays.items()})
        want = want_m.check(jstate, np.array(pose))
        for state in (filter_state_from_numpy(arrays, "cpu"),):
            got = got_m.check(state, np.array(pose))
            assert got.issues == want.issues and got.ok == want.ok
            if np.isfinite(want.neff):
                assert got.neff == pytest.approx(want.neff, rel=1e-9)
            assert got.map_fill_frac == pytest.approx(want.map_fill_frac, rel=1e-12)
            assert got.step_jump_m == pytest.approx(want.step_jump_m, rel=1e-12)
        seen.update(want.issues)
    expected = {"healthy": set(), "degenerate": {"weight_degeneracy"},
                "poisoned": {"nan_or_inf_state"},
                "full and jumping": {"map_near_capacity", "estimate_jump"}}[name]
    assert seen == expected


def test_health_check_reads_either_layout_alike():
    arrays = health_states()["healthy"]
    cfg = port_config(JaxConfig(num_particles=50, max_landmarks=8, parity_mode=False))
    blocks = filter_state_from_numpy(arrays, "cpu")
    a = HealthMonitor(cfg).check(blocks, np.zeros(3))
    b = HealthMonitor(cfg).check(to_planes(blocks, cfg), np.zeros(3))
    assert a == b


def test_recover_from_a_checkpoint(tmp_path):
    state = port_states()["blocks"]
    path = str(tmp_path / "ck.npz")
    checkpoint.save_checkpoint(path, to_planes(state, port_config(
        JaxConfig(num_particles=32, max_landmarks=4, parity_mode=False))))
    cfg = port_config(JaxConfig(num_particles=32, max_landmarks=4, parity_mode=False))
    got, generator = HealthMonitor(cfg).recover(state, np.array([np.nan, 0, 0]),
                                                checkpoint_path=path)
    assert isinstance(got, FilterState) and isinstance(generator, torch.Generator)
    for name, v in state.__dict__.items():
        assert torch.equal(getattr(got, name), v), name


@pytest.mark.parametrize("missing_checkpoint", [False, True])
def test_recover_reinitializes_at_the_last_finite_pose(tmp_path, missing_checkpoint):
    jcfg = JaxConfig(num_particles=50, max_landmarks=8)
    want_m, got_m = JaxHealthMonitor(jcfg), HealthMonitor(port_config(jcfg))
    states = health_states()
    jax_of = lambda a: jax_init_state(jcfg, rng=0)._replace(
        **{k: jnp.asarray(v) for k, v in a.items()})
    jstate, state = jax_of(states["poisoned"]), filter_state_from_numpy(states["poisoned"], "cpu")
    for m, healthy, poisoned in ((want_m, jax_of(states["healthy"]), jstate),
                                 (got_m, filter_state_from_numpy(states["healthy"], "cpu"),
                                  state)):
        m.check(healthy, np.array([1.5, -0.5, 0.25]))    # the last finite pose
        m.check(poisoned, np.array([1.7, -0.5, 0.25]))
        m._degenerate_streak = 5
    path = str(tmp_path / "absent.npz") if missing_checkpoint else None
    want = want_m.recover(jstate, np.array([np.nan, 0, 0]), checkpoint_path=path)
    got, generator = got_m.recover(state, np.array([np.nan, 0, 0]), checkpoint_path=path)
    assert generator is None    # the caller's generator carries on
    assert got_m._degenerate_streak == want_m._degenerate_streak == 0
    for name in ("poses", "log_weights", "lm_mean", "lm_cov", "lm_count"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-7, err_msg=name)
    np.testing.assert_array_equal(got.poses.numpy()[7], np.float32([1.5, -0.5, 0.25]))


# ---------------------------------------------------------------- run_driver

@pytest.fixture(scope="module")
def drive():
    return record_log(SimWorld(seed=9), num_ticks=60)


def hooked_config():
    return JaxConfig(num_particles=32, max_landmarks=16, warmup_iterations=30,
                     rotation_noise=0.0, translation_noise=0.0)


def counting(module, name, calls):
    real = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(kw.get("iteration", len(calls)))
        return real(*args, **kw)
    return wrapped


def hooked_run(monkeypatch, tmp_path, run, ser_module, ck_module, log):
    """``run`` with every hook on, counting the snapshots and recording the
    iteration of each checkpoint where the loop looks the writers up."""
    snaps, ckpts = [], []
    monkeypatch.setattr(ser_module, "serialize_tick",
                        counting(ser_module, "serialize_tick", snaps))
    monkeypatch.setattr(ck_module, "save_checkpoint",
                        counting(ck_module, "save_checkpoint", ckpts))
    hist = run(log, serialize_path=str(tmp_path / "fast_slam.json"), serialize_every=10,
               metrics_path=str(tmp_path / "metrics.jsonl"),
               checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=25, health=True)
    records = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    for r in records:
        r.pop("t")
    return hist, snaps, ckpts, records


def test_hooked_run_driver_matches_jax(monkeypatch, tmp_path, drive):
    jcfg = hooked_config()
    jlog = jax_record_log(JaxSimWorld(seed=9), num_ticks=60)
    # JAX imports its writers inside the loop, from their modules
    want = hooked_run(monkeypatch, tmp_path / "jax",
                      lambda log, **kw: jax_runner.run_driver(JaxReplayDriver(log), jcfg,
                                                              rng=0, **kw),
                      jax_serializer, jax_checkpoint, jlog)
    got = hooked_run(monkeypatch, tmp_path / "port",
                     lambda log, **kw: run_driver(ReplayDriver(log), port_config(jcfg),
                                                  rng=0, device="cpu", **kw),
                     runner, runner, drive)
    np.testing.assert_allclose(np.asarray(got[0].est_poses), np.asarray(want[0].est_poses),
                               rtol=1e-4, atol=1e-4)
    assert len(got[1]) == len(want[1]) == 6
    assert got[2] == want[2] == [25, 50]
    assert len(got[3]) == len(want[3])
    for g, w in zip(got[3], want[3]):
        assert g.keys() == w.keys()
        for k in g:
            if k == "distance":
                assert g[k] == pytest.approx(w[k], abs=1e-4)
            else:
                assert g[k] == w[k], (k, g, w)
    assert sum(r["kind"] == "tick" for r in got[3]) == 60
    snap = {tag: serializer.deserialize_tick(str(tmp_path / tag / "fast_slam.json"))
            for tag in ("jax", "port")}
    assert len(snap["port"]["particles"]) == 32
    np.testing.assert_allclose(snap["port"]["landmarks"], snap["jax"]["landmarks"], atol=1e-4)
    np.testing.assert_allclose(snap["port"]["particles"], snap["jax"]["particles"], atol=1e-4)
    state, meta = checkpoint.load_checkpoint(str(tmp_path / "port" / "ck.npz"), "cpu")
    jstate, jmeta = jax_checkpoint.load_checkpoint(str(tmp_path / "jax" / "ck.npz"))
    assert meta["iteration"] == jmeta["iteration"] == 50
    np.testing.assert_array_equal(state.lm_count.numpy(), np.asarray(jstate.lm_count))
    np.testing.assert_allclose(state.lm_mean.numpy(), np.asarray(jstate.lm_mean), atol=1e-4)


def test_hooks_change_no_estimate(tmp_path, drive):
    cfg = port_config(hooked_config()).replace(rotation_noise=0.001,
                                                translation_noise=0.0055,
                                                parity_mode=False, proposal_mode="fastslam2")
    plain = run_driver(ReplayDriver(drive), cfg, max_ticks=40, rng=4, device="cpu")
    hooked = run_driver(ReplayDriver(drive), cfg, max_ticks=40, rng=4, device="cpu",
                        serialize_path=str(tmp_path / "s.json"), serialize_every=7,
                        metrics_path=str(tmp_path / "m.jsonl"),
                        checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=15,
                        health=True)
    assert np.array_equal(np.asarray(hooked.est_poses), np.asarray(plain.est_poses))
    # a production config runs the fused tick: one "tick" stage per tick
    assert set(hooked.stage_seconds) == {"tick", "health", "metrics", "serialize",
                                         "checkpoint"}
    assert set(plain.stage_seconds) == {"tick"}
    state, meta = checkpoint.load_checkpoint(str(tmp_path / "ck.npz"), "cpu")
    assert meta["iteration"] == 30 and state.lm_mean.shape == (32, 16, 2)


def test_state_blocks_round_trip():
    cfg = port_config(hooked_config()).replace(parity_mode=False)
    r = SLAMRunner(cfg, device="cpu")
    state = init_state(cfg, "cpu")
    state = state.replace(lm_count=torch.arange(32, dtype=torch.int32) % 5,
                          lm_mean=torch.randn(state.lm_mean.shape))
    r.set_state_blocks(state)
    assert isinstance(r.state, PlanesState) and r.state.lm_cc is None
    back = r.state_blocks()
    for name, v in state.__dict__.items():
        assert torch.equal(getattr(back, name), v), name
