"""Checkpoints across the two packages and the health recovery, on the CPU.

* JAX's ``load_checkpoint`` reads a port checkpoint of each layout, with and
  without a generator: equal arrays, and the threefry key the port derives
  from the generator's initial seed.
* ``HealthMonitor.recover`` from a checkpoint of JAX's ``run_driver`` on the
  planes engine at P = 100 (saved at the lane tile's 128) keeps the first
  100 particles, and the next tick runs; a checkpoint with fewer particles
  than the config is refused, naming both counts.
* After a NaN recovery inside ``run_driver`` the draws come from the
  checkpoint's generator; after a recovery with no checkpoint, from the
  run's own.
"""

import jax
import numpy as np
import pytest
import torch

from fastslam_tpu.app import runner as jax_runner
from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.drivers.replay import ReplayDriver as JaxReplayDriver
from fastslam_tpu.drivers.replay import record_log as jax_record_log
from fastslam_tpu.drivers.sim_world import SimWorld as JaxSimWorld
from fastslam_tpu.io import checkpoint as jax_checkpoint

from fastslam_tpu_torch.app.runner import SLAMRunner, run_driver, scan_points
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import init_state, to_planes
from fastslam_tpu_torch.drivers.replay import ReplayDriver, record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.io import checkpoint
from fastslam_tpu_torch.utils.health import HealthMonitor

torch.set_num_threads(1)


def port_state(layout):
    """A blocks state with landmarks and spread weights, in ``layout``."""
    p, l = 24, 6
    rng = np.random.default_rng(12)
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=l,
                         parity_mode=layout == "planes parity")
    state = init_state(cfg, "cpu").replace(
        poses=torch.from_numpy(rng.normal(size=(p, 3)).astype(np.float32)),
        log_weights=torch.from_numpy(np.log(rng.dirichlet(np.ones(p))).astype(np.float32)),
        lm_mean=torch.from_numpy(rng.normal(size=(p, l, 2)).astype(np.float32)),
        lm_cov=torch.from_numpy(rng.normal(size=(p, l, 4)).astype(np.float32)),
        lm_count=torch.from_numpy(rng.integers(0, l + 1, p).astype(np.int32)))
    return state if layout == "blocks" else to_planes(state, cfg)


@pytest.mark.parametrize("with_generator", [False, True])
@pytest.mark.parametrize("layout", ["blocks", "planes production", "planes parity"])
def test_jax_loads_a_port_checkpoint(tmp_path, layout, with_generator):
    state = port_state(layout)
    gen = torch.Generator().manual_seed(2 ** 40 + 12345) if with_generator else None
    path = str(tmp_path / "ck.npz")
    checkpoint.save_checkpoint(path, state, iteration=9, robot_pose=np.array([1.0, 0, 0.5]),
                               extra={"note": np.arange(2)}, generator=gen)
    jstate, jmeta = jax_checkpoint.load_checkpoint(path)
    assert jmeta["iteration"] == 9
    np.testing.assert_array_equal(jmeta["robot_pose"], [1.0, 0, 0.5])
    np.testing.assert_array_equal(jmeta["extra"]["note"], np.arange(2))
    assert type(jstate).__name__ == ("FilterState" if layout == "blocks" else "PlanesState")
    for name, v in state.__dict__.items():
        if v is None:                              # production: no cc plane
            assert getattr(jstate, name) is None, name
        else:
            np.testing.assert_array_equal(np.asarray(getattr(jstate, name)), v.numpy(),
                                          err_msg=name)
    key = np.asarray(jax.random.key_data(jstate.rng))
    want = [2 ** 8, 12345] if with_generator else [0, 0]
    np.testing.assert_array_equal(key, np.array(want, np.uint32))
    # the port's own loader still continues the saved stream
    _, meta = checkpoint.load_checkpoint(path, "cpu")
    if with_generator:
        assert torch.equal(torch.randn(4, generator=meta["generator"]),
                           torch.randn(4, generator=gen))


def test_recover_from_a_padded_jax_checkpoint_runs_the_next_tick(tmp_path):
    jcfg = JaxConfig(num_particles=100, max_landmarks=16, parity_mode=False,
                     use_pallas=True, pallas_interpret=True, warmup_iterations=2)
    path = str(tmp_path / "ck.npz")
    jax_runner.run_driver(JaxReplayDriver(jax_record_log(JaxSimWorld(seed=3), num_ticks=6)),
                          jcfg, max_ticks=6, rng=0, checkpoint_path=path, checkpoint_every=5)
    saved, _ = jax_checkpoint.load_checkpoint(path)
    assert saved.num_particles == 128             # the planes engine's lane tile

    cfg = FastSLAMConfig(num_particles=100, max_landmarks=16, parity_mode=False,
                         warmup_iterations=2)
    runner = SLAMRunner(cfg, device="cpu")
    state, generator = HealthMonitor(cfg).recover(runner.state, np.array([np.nan, 0, 0]),
                                                  checkpoint_path=path)
    assert state.num_particles == 100 and isinstance(generator, torch.Generator)
    for name in ("poses", "log_weights", "lm_mean", "lm_cov", "lm_count"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(saved, name))[:100], err_msg=name)
    runner.set_state_blocks(state)
    runner._generator = generator
    pts, valid = scan_points(record_log(SimWorld(seed=3), num_ticks=2))
    est = runner.tick(pts[1], valid[1], 0.0, 0.4)
    assert np.isfinite(est).all() and runner.state.num_particles == 100
    assert bool(torch.isfinite(runner.state.log_weights).all())


def test_recover_refuses_a_checkpoint_with_fewer_particles(tmp_path):
    path = str(tmp_path / "ck.npz")
    checkpoint.save_checkpoint(path, port_state("blocks"))          # 24 particles
    cfg = FastSLAMConfig(num_particles=40, max_landmarks=6)
    monitor = HealthMonitor(cfg)
    with pytest.raises(ValueError, match=r"24 particles.*num_particles = 40"):
        monitor.recover(init_state(cfg, "cpu"), np.zeros(3), checkpoint_path=path)


@pytest.mark.parametrize("from_checkpoint", [True, False])
def test_draws_after_a_nan_recovery(monkeypatch, tmp_path, from_checkpoint):
    """Tick 4's step poisons the weights; the health check recovers, and
    tick 5 draws from the checkpoint's generator (from the run's own when
    the recovery re-initializes)."""
    cfg = FastSLAMConfig(num_particles=32, max_landmarks=16, parity_mode=False,
                         warmup_iterations=3)
    path = str(tmp_path / "ck.npz")
    ck_gen = torch.Generator().manual_seed(77)
    torch.randn(3, generator=ck_gen)
    checkpoint.save_checkpoint(path, init_state(cfg, "cpu"), generator=ck_gen)
    log = record_log(SimWorld(seed=9), num_ticks=7)
    draw, step = kernels.draw, kernels.fastslam_step_planes

    def run(poison):
        draws = []

        def recording_draw(*args, **kw):
            draws.append(draw(*args, **kw))
            return draws[-1]

        def poisoned_step(state, *args, **kw):
            state, est = step(state, *args, **kw)
            if poison and len(draws) == 5:
                state = state.replace(log_weights=torch.full_like(state.log_weights, np.nan))
            return state, est

        monkeypatch.setattr(kernels, "draw", recording_draw)
        monkeypatch.setattr(kernels, "fastslam_step_planes", poisoned_step)
        hist = run_driver(ReplayDriver(log), cfg, rng=4, device="cpu", health=True,
                          checkpoint_path=path if from_checkpoint else None,
                          checkpoint_every=1000)
        return draws, hist

    draws, hist = run(poison=True)
    assert len(draws) == 7 and np.isfinite(np.asarray(hist.est_poses)[5:]).all()
    clean = run(poison=False)[0][5]
    want = draw(ck_gen, cfg.num_particles) if from_checkpoint else clean
    assert torch.equal(draws[5].rot, want.rot) and torch.equal(draws[5].trans, want.trans)
    if from_checkpoint:
        assert not torch.equal(want.rot, clean.rot)
