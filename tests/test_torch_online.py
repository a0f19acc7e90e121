"""The online loop: the port's ``run_driver`` and ``SLAMRunner`` against the
JAX package's split path (``fuse_online_tick=False``, Pallas interpret
mode), P=128, L=16, on the recorded seed-3 drive.

Without motion noise every particle stays identical, so both loops are
deterministic whatever their draws, and the estimates agree per tick at
1e-4, in production and parity mode, with and without the ICP refinement.
The ICP refinement with adaptive floors (fs2) is held tick by tick: its
refined odometry, blends and floors at atol 1e-5.  The floors come out of
medians of ICP residuals, which differ from JAX's by the ICP tolerance, so
they agree to ~6e-7, not bit for bit.  The mode dial is a ramp of the floors
of slope 1 / (fs2_dial_hi_floor - fs2_dial_lo_floor) = 400, so it may differ
by at most that slope times the tick's larger floor difference (a floor
5.6e-7 off moved the dial 2.2e-4 on the clean drive); it is held there.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fastslam_tpu.app.runner import SLAMRunner as JaxRunner
from fastslam_tpu.app.runner import run_driver as jax_run_driver
from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.drivers.replay import ReplayDriver as JaxReplayDriver

from fastslam_tpu_torch.app import cli
from fastslam_tpu_torch.app.runner import SLAMRunner, run_driver
from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.drivers.replay import ReplayDriver, record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.interop import config_from_jax_fields

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def drive():
    return record_log(SimWorld(seed=3), num_ticks=32)


def jax_config(**kw):
    kw.setdefault("parity_mode", False)
    return JaxConfig(num_particles=128, max_landmarks=16, use_pallas=True,
                     pallas_interpret=True, fuse_online_tick=False,
                     warmup_iterations=8, **kw)


@pytest.mark.parametrize("parity,icp", [(False, False), (True, False), (False, True),
                                        (True, True)])
def test_noise_free_online_loop_matches_jax(drive, parity, icp):
    jcfg = jax_config(parity_mode=parity, rotation_noise=0.0, translation_noise=0.0,
                      use_icp_proposal=icp, icp_blend=0.5)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    want = jax_run_driver(JaxReplayDriver(drive), jcfg, rng=0)
    launches = dict(cuda_kernels.LAUNCHES)
    got = run_driver(ReplayDriver(drive), cfg, rng=0, device="cpu")
    assert cuda_kernels.LAUNCHES == launches   # the CPU runs no kernel
    est = np.asarray(got.est_poses)
    assert est.shape == (32, 3)
    np.testing.assert_allclose(est, np.asarray(want.est_poses), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.gt_poses), np.asarray(want.gt_poses))
    assert got.num_measurements == want.num_measurements
    assert max(got.num_measurements) > 0
    assert got.final_floors is None and want.final_floors is None


def odometry_stream(log, slip, seed=123):
    """(points, valid, rotation, translation, v) per tick, as ``run_driver``
    pairs them, with wheel slip on the active component."""
    runner = SLAMRunner(config_from_jax_fields(dataclasses.asdict(jax_config())),
                        device="cpu")
    rng = np.random.default_rng(seed)
    drv = ReplayDriver(log)
    prev_cmd = (0.0, 0.0)
    for _ in range(len(log)):
        scan = drv.get_laser()
        pts, valid = scan.to_points()
        v, w = prev_cmd
        prev_cmd = drv.commanded_velocity()
        rot, tr = runner.odometry(v, w, scan.timestamp)
        if rot != 0.0:
            rot += rng.normal(0.0, slip[0])
        if tr != 0.0:
            tr += rng.normal(0.0, slip[1])
        yield pts, valid, rot, tr, v
        drv.step()


@pytest.mark.parametrize("slip", [(0.0, 0.0), (0.02, 0.02)])
def test_icp_refine_with_adaptive_floors_matches_jax_tick_by_tick(slip):
    """120 ticks (translation, then the first turn from tick ~87): the
    refined odometry, the floors and the dial of every tick."""
    log = record_log(SimWorld(seed=3), num_ticks=120)
    jcfg = jax_config(proposal_mode="fastslam2", use_icp_proposal=True, icp_blend=0.0,
                      adaptive_proposal_floors=True)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    want_r, got_r = JaxRunner(jcfg, rng=0), SLAMRunner(cfg, device="cpu")
    dial_slope = 1.0 / (cfg.fs2_dial_hi_floor - cfg.fs2_dial_lo_floor)
    seen = {"rotation": 0, "blend": 0, "dial": set()}
    for t, (pts, valid, rot, tr, v) in enumerate(odometry_stream(log, slip)):
        want = want_r.icp_refine(pts, valid, rot, tr, v)
        got = got_r.icp_refine(pts, valid, rot, tr, v)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=f"tick {t}")
        for name in ("_floor_xy", "_floor_th", "_blend_xy", "_blend_th", "_bias_th"):
            np.testing.assert_allclose(getattr(got_r, name), getattr(want_r, name),
                                       rtol=0, atol=1e-5, err_msg=f"tick {t} {name}")
        floor_diff = max(abs(got_r._floor_xy - want_r._floor_xy),
                         abs(got_r._floor_th - want_r._floor_th))
        np.testing.assert_allclose(got_r._dial, want_r._dial, rtol=0,
                                   atol=dial_slope * floor_diff + 1e-7,
                                   err_msg=f"tick {t} _dial")
        seen["rotation"] += v == 0
        seen["blend"] += got_r._blend_xy > 0
        seen["dial"].add(round(got_r._dial, 3))
    assert seen["rotation"] > 10 and len(seen["dial"]) > 2
    if slip != (0.0, 0.0):
        assert seen["blend"] > 10   # slip engages the translation blend


def test_adaptive_floors_need_icp_and_fs2():
    base = config_from_jax_fields(dataclasses.asdict(jax_config()))
    for kw in ({"adaptive_proposal_floors": True},
               {"adaptive_proposal_floors": True, "use_icp_proposal": True},
               {"adaptive_proposal_floors": True, "proposal_mode": "fastslam2"}):
        with pytest.raises(ValueError, match="use_icp_proposal"):
            SLAMRunner(base.replace(**kw), device="cpu")
    SLAMRunner(base.replace(adaptive_proposal_floors=True, use_icp_proposal=True,
                            proposal_mode="fastslam2"), device="cpu")


def test_adaptive_online_loop_records_its_floors(drive):
    cfg = config_from_jax_fields(dataclasses.asdict(jax_config(
        proposal_mode="fastslam2", use_icp_proposal=True, icp_blend=0.0,
        adaptive_proposal_floors=True)))
    hist = run_driver(ReplayDriver(drive), cfg, rng=0, device="cpu")
    assert np.isfinite(np.asarray(hist.est_poses)).all()
    assert hist.metrics()["ate_rmse_m"] < 0.25
    assert len(hist.final_floors) == 2 and len(hist.final_floors_by_type) == 2
    assert min(hist.final_floors) >= cfg.proposal_floor_min


def test_online_loop_records_its_stage_times():
    cfg = config_from_jax_fields(dataclasses.asdict(jax_config(
        use_icp_proposal=True, icp_blend=0.5)))
    hist = run_driver(SimWorld(seed=2), cfg, max_ticks=6, rng=0, device="cpu")
    assert len(hist.est_poses) == 6
    assert set(hist.stage_seconds) == {"icp_refine", "tick"}
    assert all(s > 0.0 for s in hist.stage_seconds.values())


def test_cli_online_run_and_sim_are_run_driver(tmp_path, capsys):
    """``run`` without ``--chunk`` is ``run_driver(ReplayDriver(log))`` and
    ``sim`` is ``run_driver(SimWorld)``, parity mode unless ``--production``
    (then with the config's default ``fuse_online_tick=True``: the fused
    tick)."""
    log_path = str(tmp_path / "log.npz")
    record_log(SimWorld(seed=3), num_ticks=16).save(log_path)
    from fastslam_tpu_torch.drivers.replay import LaserLog

    small = ["--particles", "32", "--landmarks", "16", "--warmup", "4", "--seed", "2",
             "--device", "cpu"]
    cfg = config_from_jax_fields(dataclasses.asdict(jax_config()))
    cfg = cfg.replace(num_particles=32, warmup_iterations=4, max_landmarks=16)
    for argv, hist in (
        (["run", "--log", log_path],
         lambda: run_driver(ReplayDriver(LaserLog.load(log_path)),
                            cfg.replace(parity_mode=True), rng=2, device="cpu")),
        (["sim", "--ticks", "10", "--production"],
         lambda: run_driver(SimWorld(seed=2), cfg.replace(fuse_online_tick=True),
                            max_ticks=10, rng=2, device="cpu")),
    ):
        capsys.readouterr()
        assert cli.main(argv + small) == 0
        out = json.loads(capsys.readouterr().out)
        assert out.pop("device") == "cpu"
        assert out == hist().metrics(), argv
