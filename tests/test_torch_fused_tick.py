"""The fused online tick: the port's ``SLAMRunner.tick_fused`` against the
JAX package's ``tick_fused`` (Pallas interpret mode), P=128, L=16, on the
recorded seed-3 drive.

The two runners step in lockstep.  In motion mode and with corner tracking
the drive is noise-free, so every particle stays identical and the
estimates agree per tick at 1e-4 whatever the draws.  With fs2 + ICP +
adaptive floors the proposal samples with the floors' noise, so before each
tick the port's draws are replaced by the ones JAX's step takes
(``jax.random.split(state.rng, 4)``: the pose noise from the second key, the
resample offset from the fourth).  The refined odometry ``out[3:5]`` and the
floors are held tick by tick as ``test_torch_online.py`` holds them: at atol
1e-5, and the mode dial within its slope (400) times the tick's floor
difference, since the floors come out of medians of ICP residuals that differ
from JAX's by the ICP tolerance.

The port's match-failure gate fails a match on ``|t_y| > lat_gate`` where
JAX's fused gate fails it on ``>=``; no tick of these drives sits on the tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.app.runner import SLAMRunner as JaxRunner
from fastslam_tpu.config import FastSLAMConfig as JaxConfig

from fastslam_tpu_torch.app import runner as runner_mod
from fastslam_tpu_torch.app.runner import SLAMRunner, run_driver
from fastslam_tpu_torch.core import cuda_kernels, kernels
from fastslam_tpu_torch.drivers.replay import ReplayDriver, record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.interop import config_from_jax_fields

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def drive():
    return record_log(SimWorld(seed=3), num_ticks=40)


def jax_config(**kw):
    return JaxConfig(num_particles=128, max_landmarks=16, use_pallas=True,
                     pallas_interpret=True, parity_mode=False, warmup_iterations=8, **kw)


def jax_draws(jax_runner, fs2):
    """The draws JAX's next planes step takes from its state's key."""
    p = jax_runner.state.poses.shape[0]
    _, k_rot, k_trans, k_u = jax.random.split(jax_runner.state.rng, 4)
    u0 = torch.tensor(float(jax.random.uniform(k_u, (), jnp.float32, maxval=1.0 / p)))
    if fs2:
        noise = torch.tensor(np.asarray(jax.random.normal(k_rot, (p, 3), jnp.float32)))
        return kernels.Draws(None, None, u0, noise)
    return kernels.Draws(torch.tensor(np.asarray(jax.random.normal(k_rot, (p,), jnp.float32))),
                         torch.tensor(np.asarray(jax.random.normal(k_trans, (p,),
                                                                   jnp.float32))), u0)


def lockstep(log, jcfg, monkeypatch, n):
    """Drive JAX's and the port's fused ticks over ``n`` ticks of ``log``;
    returns the per-tick estimates, ``out`` rows and runners."""
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    want_r, got_r = JaxRunner(jcfg, rng=0), SLAMRunner(cfg, device="cpu")
    assert want_r._fused is not None and got_r._fused is not None
    jax_outs = []
    fused = want_r._fused

    def recording(*args):
        res = fused(*args)
        jax_outs.append(np.asarray(res[2]))
        return res
    want_r._fused = recording
    fs2 = kernels.uses_fs2(cfg)
    pending = []
    monkeypatch.setattr(kernels, "draw", lambda *a, **kw: pending.pop())
    drv = ReplayDriver(log)
    prev_cmd = (0.0, 0.0)
    rows = []
    for _ in range(n):
        scan = drv.get_laser()
        pts, valid = scan.to_points()
        v, w = prev_cmd
        prev_cmd = drv.commanded_velocity()
        rot, tr = want_r.odometry(v, w, scan.timestamp)
        assert got_r.odometry(v, w, scan.timestamp) == (rot, tr)
        pending.append(jax_draws(want_r, fs2))
        got = got_r.tick_fused(pts, valid, rot, tr, v)
        want = want_r.tick_fused(pts, valid, rot, tr, v)
        rows.append((got, want, got_r._last_out.copy(), jax_outs[-1],
                     (got_r._floor_xy, got_r._floor_th, got_r._dial),
                     (want_r._floor_xy, want_r._floor_th, want_r._dial)))
        drv.step()
    return rows, got_r, want_r


@pytest.mark.parametrize("mode", ["motion", "tracking", "fs2_icp_adaptive"])
def test_fused_tick_matches_jax(drive, monkeypatch, mode):
    kw = dict(rotation_noise=0.0, translation_noise=0.0)
    if mode == "tracking":
        kw.update(track_corners=True)
    if mode == "fs2_icp_adaptive":
        kw.update(proposal_mode="fastslam2", use_icp_proposal=True, icp_blend=0.0,
                  adaptive_proposal_floors=True)
    launches = dict(cuda_kernels.LAUNCHES)
    rows, got_r, want_r = lockstep(drive, jax_config(**kw), monkeypatch, len(drive))
    assert cuda_kernels.LAUNCHES == launches   # the CPU runs no kernel
    cfg = got_r.config
    dial_slope = 1.0 / (cfg.fs2_dial_hi_floor - cfg.fs2_dial_lo_floor)
    for t, (got, want, g_out, w_out, g_fl, w_fl) in enumerate(rows):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=f"tick {t}")
        assert g_out[5] == w_out[5], f"tick {t}: measurement count"
        # the refined odometry and the floors it was refined with
        np.testing.assert_allclose(g_out[3:5], w_out[3:5], rtol=0, atol=1e-5,
                                   err_msg=f"tick {t}")
        np.testing.assert_allclose(g_fl[:2], w_fl[:2], rtol=0, atol=1e-5, err_msg=f"tick {t}")
        floor_diff = max(abs(g_fl[0] - w_fl[0]), abs(g_fl[1] - w_fl[1]))
        np.testing.assert_allclose(g_fl[2], w_fl[2], rtol=0,
                                   atol=dial_slope * floor_diff + 1e-7, err_msg=f"tick {t}")
    assert max(r[2][5] for r in rows) > 0
    assert got_r._fused.replays == 0 and got_r._fused.graph is None   # no graph off the card
    if mode == "tracking":
        for name in ("hits", "misses", "track_id"):
            np.testing.assert_array_equal(getattr(got_r._tracks, name).numpy(),
                                          np.asarray(getattr(want_r._tracks, name)))
        assert int(got_r._tracks.next_id) == int(want_r._tracks.next_id) > 0
        np.testing.assert_allclose(got_r._tracks.pos.numpy(), np.asarray(want_r._tracks.pos),
                                   atol=1e-5)
    if mode == "fs2_icp_adaptive":
        outs = np.asarray([r[2] for r in rows])
        # the two-step match ran on the scans t-2 and t from tick 2 on
        assert np.abs(outs[2:, 11:14]).max() > 0.01
        np.testing.assert_allclose(outs[:, 8:14], np.asarray([r[3] for r in rows])[:, 8:14],
                                   rtol=0, atol=1e-4)


def test_run_driver_takes_the_fused_path_in_production(drive, monkeypatch):
    """``run_driver`` on a production config goes through ``tick_fused``
    (one ``_FusedTick`` call per tick, the split path never); parity mode,
    or ``fuse_online_tick=False``, keeps ``_fused is None``."""
    cfg = config_from_jax_fields(dataclasses.asdict(jax_config(
        proposal_mode="fastslam2", use_icp_proposal=True, icp_blend=0.0,
        adaptive_proposal_floors=True)))
    calls = {"fused": 0}
    real = runner_mod._FusedTick.__call__

    def counting(self, *args):
        calls["fused"] += 1
        return real(self, *args)
    monkeypatch.setattr(runner_mod._FusedTick, "__call__", counting)
    monkeypatch.setattr(SLAMRunner, "tick", lambda *a, **k: pytest.fail("split path"))
    hist = run_driver(ReplayDriver(drive), cfg, rng=0, device="cpu")
    assert calls["fused"] == len(drive) == len(hist.est_poses)
    assert set(hist.stage_seconds) == {"tick"} and hist.graph_replays == 0
    assert hist.metrics()["ate_rmse_m"] < 0.25
    assert hist.final_floors is not None and len(hist.final_floors_by_type) == 2
    assert SLAMRunner(cfg.replace(parity_mode=True, proposal_mode="motion",
                                  use_icp_proposal=False, adaptive_proposal_floors=False),
                      device="cpu")._fused is None
    assert SLAMRunner(cfg.replace(fuse_online_tick=False), device="cpu")._fused is None


def test_fused_tick_refuses_a_scan_of_another_width(drive):
    """The fused tick's static buffers hold one scan width; a scan of
    another beam count is refused, not silently cut."""
    cfg = config_from_jax_fields(dataclasses.asdict(jax_config()))
    runner = SLAMRunner(cfg, device="cpu")
    pts, valid = ReplayDriver(drive).get_laser().to_points()
    runner.tick_fused(pts, valid, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="180 beams"):
        runner.tick_fused(pts[:90], valid[:90], 0.0, 0.1, 0.3)


@pytest.mark.parametrize("collapse", [False, True])
def test_on_device_resample_decision_equals_the_host_branch(collapse):
    """The step with the resample decided on the device (an identity gather
    when no resample is due) leaves the state of the host branch bit for
    bit, on healthy weights (no resample) and on collapsed ones (resample)."""
    from fastslam_tpu_torch.core.state import init_planes_state

    cfg = config_from_jax_fields(dataclasses.asdict(jax_config()))
    gen = torch.Generator().manual_seed(3)
    state = init_planes_state(cfg, "cpu")
    p, l = cfg.num_particles, cfg.max_landmarks
    logw = 0.01 * torch.randn(p, generator=gen)
    if collapse:
        logw[7] = 40.0
    state = state.replace(poses=torch.randn((p, 3), generator=gen), log_weights=logw,
                          lm_mx=torch.randn((l, p), generator=gen),
                          lm_count=torch.randint(0, l, (p,), generator=gen,
                                                 dtype=torch.int32))
    u0 = torch.tensor(0.3 / p)
    host = kernels._normalize_and_resample(state.clone(), u0, cfg)
    dev = kernels._normalize_and_resample(state.clone(), u0, cfg, on_device=True)
    for name, want in host.__dict__.items():
        got = getattr(dev, name)
        assert (got is None) == (want is None), name
        if want is not None:
            assert torch.equal(got, want), name
    resampled = not torch.equal(host.lm_mx, state.lm_mx)
    assert resampled == collapse
