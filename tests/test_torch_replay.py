"""The slice as a whole: the port's ``replay_chunked`` against the JAX one
(Pallas interpret mode) on a recorded 48-tick synthetic drive, P=128, L=16.

``warmup_iterations=8``: the default 150 would overwrite every estimate with
dead reckoning.  Without motion noise both runs are deterministic (all
particles stay identical, so nothing resamples and the draws do not matter)
and the estimates agree per tick at 1e-4, with the ICP refinement of the
odometry too.  With noise the two random streams differ, so both are held to
the accuracy bar instead.  The ICP and adaptive-floor stage is also held on
its own against the JAX package's functions, called as its replay calls
them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.app.runner import replay_chunked as jax_replay_chunked
from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.proposal import adaptive as jax_adaptive
from fastslam_tpu.proposal.icp import icp_point_to_line as jax_icp_point_to_line
from fastslam_tpu.proposal.icp import rotate_points as jax_rotate_points

from fastslam_tpu_torch.app import cli
from fastslam_tpu_torch.app.runner import (
    icp_floor_stage, odometry, replay_chunked, run_driver, scan_points,
)
from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.drivers.replay import LaserLog, record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.interop import config_from_jax_fields

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def drive():
    return record_log(SimWorld(seed=3), num_ticks=48)


def jax_config(**kw):
    return JaxConfig(num_particles=128, max_landmarks=16, parity_mode=False,
                     use_pallas=True, pallas_interpret=True, warmup_iterations=8,
                     **kw)


# 48 = 6 x 8; 4 x 10 + 8 tail ticks; wheel slip drawn from the same numpy seed
@pytest.mark.parametrize("chunk,slip", [(8, (0.0, 0.0)), (10, (0.0, 0.0)),
                                        (8, (0.01, 0.02))])
def test_noise_free_replay_matches_jax(drive, chunk, slip):
    jcfg = jax_config(rotation_noise=0.0, translation_noise=0.0)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    want = jax_replay_chunked(drive, jcfg, chunk_size=chunk, rng=0,
                              odometry_noise=slip)
    launches = dict(cuda_kernels.LAUNCHES)
    got = replay_chunked(drive, cfg, chunk_size=chunk, rng=0, device="cpu",
                         odometry_noise=slip)
    assert cuda_kernels.LAUNCHES == launches   # the CPU runs no kernel
    est, want_est = np.asarray(got.est_poses), np.asarray(want.est_poses)
    assert est.shape == (48, 3)
    np.testing.assert_allclose(est, want_est, rtol=1e-4, atol=1e-4)
    assert got.num_measurements == want.num_measurements
    assert max(got.num_measurements) > 0
    np.testing.assert_allclose(np.asarray(got.gt_poses), np.asarray(want.gt_poses))


def test_noisy_replay_tracks_like_jax(drive):
    jcfg = jax_config()
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    ate_jax = jax_replay_chunked(drive, jcfg, chunk_size=8, rng=0).metrics()["ate_rmse_m"]
    ate = replay_chunked(drive, cfg, chunk_size=8, rng=0, device="cpu").metrics()["ate_rmse_m"]
    assert np.isfinite(ate) and np.isfinite(ate_jax)
    assert ate < 0.3 and ate_jax < 0.3, (ate, ate_jax)


def test_fs2_replay_tracks_like_jax(drive):
    """``proposal_mode="fastslam2"``: 4 chunks of 10 and 8 per-tick tail
    ticks on both sides, each held to the JAX package's fs2 replay bar
    (ATE < 0.25 m, ``tests/test_drivers_e2e.py``)."""
    jcfg = jax_config(proposal_mode="fastslam2")
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    ate_jax = jax_replay_chunked(drive, jcfg, chunk_size=10, rng=0).metrics()["ate_rmse_m"]
    launches = dict(cuda_kernels.LAUNCHES)
    hist = replay_chunked(drive, cfg, chunk_size=10, rng=0, device="cpu")
    assert cuda_kernels.LAUNCHES == launches   # the CPU runs no kernel
    est = np.asarray(hist.est_poses)
    assert est.shape == (48, 3) and np.isfinite(est).all()
    ate = hist.metrics()["ate_rmse_m"]
    assert ate < 0.25 and ate_jax < 0.25, (ate, ate_jax)


def adaptive_jax_config(**kw):
    return jax_config(proposal_mode="fastslam2", use_icp_proposal=True, icp_blend=0.0,
                      adaptive_proposal_floors=True, **kw)


@pytest.mark.parametrize("blend,slip", [(0.5, (0.0, 0.0)), (1.0, (0.0, 0.0)),
                                        (0.5, (0.01, 0.02)), (1.0, (0.01, 0.02))])
def test_noise_free_icp_replay_matches_jax(drive, blend, slip):
    """Motion proposal with the ICP-refined odometry at a fixed blend."""
    jcfg = jax_config(rotation_noise=0.0, translation_noise=0.0,
                      use_icp_proposal=True, icp_blend=blend)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    want = jax_replay_chunked(drive, jcfg, chunk_size=8, rng=0, odometry_noise=slip)
    launches = dict(cuda_kernels.LAUNCHES)
    got = replay_chunked(drive, cfg, chunk_size=8, rng=0, device="cpu",
                         odometry_noise=slip)
    assert cuda_kernels.LAUNCHES == launches   # the CPU runs no kernel
    np.testing.assert_allclose(np.asarray(got.est_poses), np.asarray(want.est_poses),
                               rtol=1e-4, atol=1e-4)
    assert got.num_measurements == want.num_measurements


def jax_icp_floor_stage(pts, valid, rots, trans, v_active, config):
    """``fastslam_tpu/app/runner.py:849-948`` with the JAX package's own
    functions: the blended odometry, floors and dial of its replay."""
    t_total = len(rots)

    def match(prev_p, cur_p, prev_v, cur_v, warm_ang, warm_t):
        pre = jax_rotate_points(prev_p, warm_ang) + warm_t
        res = jax_icp_point_to_line(pre, cur_p, prev_v, cur_v, config)
        return (warm_ang + res.theta,
                jax_rotate_points(warm_t, res.theta) + res.translation)

    def one_icp(inp):
        prev_p, cur_p, prev_v, cur_v, rot, tr, va = inp
        ang, t_comp = match(prev_p, cur_p, prev_v, cur_v, -rot,
                            jnp.stack([-tr, jnp.float32(0.0)]))
        return (jnp.where(va, 0.0, -ang), jnp.where(va, -t_comp[0], 0.0), ang,
                t_comp)

    def two_step(inp):
        p2, cur_p, v2, cur_v, rot1, tr1, rot2, tr2 = inp
        warm_ang = -(rot1 + rot2)
        warm_t = (jax_rotate_points(jnp.stack([-tr1, jnp.float32(0.0)]), -rot2)
                  + jnp.stack([-tr2, jnp.float32(0.0)]))
        return match(p2, cur_p, v2, cur_v, warm_ang, warm_t)

    pts_j, val_j = jnp.asarray(pts), jnp.asarray(valid)
    icp_rots, icp_trs, angs, tvecs = jax.jit(lambda xs: jax.lax.map(one_icp, xs))((
        pts_j[:-1], pts_j[1:], val_j[:-1], val_j[1:], jnp.asarray(rots[1:]),
        jnp.asarray(trans[1:]), jnp.asarray(v_active[1:])))
    icp_rots = np.concatenate([[0.0], np.asarray(icp_rots)])
    icp_trs = np.concatenate([[0.0], np.asarray(icp_trs)])
    dir_ang, dir_t = jax.jit(lambda xs: jax.lax.map(two_step, xs))((
        pts_j[:-2], pts_j[2:], val_j[:-2], val_j[2:], jnp.asarray(rots[1:-1]),
        jnp.asarray(trans[1:-1]), jnp.asarray(rots[2:]), jnp.asarray(trans[2:])))
    d_ang, d_t2 = jax_adaptive.consistency_discrepancy(angs, tvecs, dir_ang, dir_t)
    sr_th, sr_al, lat = jax_adaptive.se2_residuals(angs, tvecs, rots, trans)
    sched = jax_adaptive.floor_schedule(sr_th, sr_al, lat, d_ang, d_t2, v_active,
                                        config)
    icp_rots = np.where(v_active, icp_rots, icp_rots - sched.bias_th).astype(np.float32)
    bad = np.abs(lat) > sched.lat_gate
    a_r = np.where(bad, 0.0, sched.blend_th).astype(np.float32)
    a_t = np.where(bad, 0.0, sched.blend_xy).astype(np.float32)
    blend = np.arange(t_total) > 0
    rots = np.where(blend, (1 - a_r) * rots + a_r * icp_rots, rots).astype(np.float32)
    trans = np.where(blend, (1 - a_t) * trans + a_t * icp_trs, trans).astype(np.float32)
    return rots, trans, sched.floors_xy, sched.floors_th, sched.dial


@pytest.mark.parametrize("slip", [(0.0, 0.0), (0.02, 0.02)])
def test_icp_floor_stage_matches_jax(drive, slip):
    """fs2 + ICP + adaptive floors: blended odometry, floors and dial of the
    whole drive within atol 1e-5 (floors and dial are medians of the
    residual windows, so they come out equal)."""
    jcfg = adaptive_jax_config()
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    pts, valid = scan_points(drive)
    rots, trans = odometry(drive, cfg)
    v_active = np.concatenate([[False], drive.cmd_v[:-1] != 0])
    rng = np.random.default_rng(5)
    rots = np.where(rots != 0, rots + rng.normal(0, slip[0], 48), rots).astype(np.float32)
    trans = np.where(trans != 0, trans + rng.normal(0, slip[1], 48), trans).astype(np.float32)
    want = jax_icp_floor_stage(pts, valid, rots, trans, v_active, jcfg)
    got = icp_floor_stage(torch.from_numpy(pts), torch.from_numpy(valid), rots, trans,
                          v_active, cfg)
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == np.float32 and g.shape == (48,), name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
    assert got.floors_xy.min() < cfg.proposal_xy_floor   # the floors adapted


def test_adaptive_replay_tracks_like_jax(drive):
    """fs2 + ICP + adaptive floors, 6 chunks of 8 on both sides, each held to
    the JAX package's fs2 replay bar (ATE < 0.25 m)."""
    jcfg = adaptive_jax_config()
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    want = jax_replay_chunked(drive, jcfg, chunk_size=8, rng=0)
    launches = dict(cuda_kernels.LAUNCHES)
    got = replay_chunked(drive, cfg, chunk_size=8, rng=0, device="cpu")
    assert cuda_kernels.LAUNCHES == launches   # the CPU runs no kernel
    est = np.asarray(got.est_poses)
    assert est.shape == (48, 3) and np.isfinite(est).all()
    ate, ate_jax = got.metrics()["ate_rmse_m"], want.metrics()["ate_rmse_m"]
    assert ate < 0.25 and ate_jax < 0.25, (ate, ate_jax)
    np.testing.assert_allclose(got.floor_traj[0], want.floor_traj[0], atol=1e-5)
    np.testing.assert_allclose(got.final_floors, want.final_floors, atol=1e-5)


def test_replay_refuses_paths_not_ported(drive, tmp_path):
    """Parity replay is refused; the online loop's hooks, each alone, its
    corner tracking (split and fused), and the replay's fs2, ICP and
    adaptive floors run."""
    cfg = config_from_jax_fields(dataclasses.asdict(jax_config()))
    with pytest.raises(ValueError, match="production"):
        replay_chunked(drive, cfg.replace(parity_mode=True), device="cpu")
    from fastslam_tpu_torch.drivers.replay import ReplayDriver

    short = record_log(SimWorld(seed=3), num_ticks=6)
    for kw in ({"serialize_path": str(tmp_path / "x.json")},
               {"metrics_path": str(tmp_path / "m.jsonl")},
               {"checkpoint_path": str(tmp_path / "c.npz"), "checkpoint_every": 5},
               {"health": True}):
        hist = run_driver(ReplayDriver(short), cfg, device="cpu", **kw)
        assert len(hist.est_poses) == 6, kw
    assert all((tmp_path / f).is_file() for f in ("x.json", "m.jsonl", "c.npz"))
    for fuse in (False, True):
        tracked = cfg.replace(track_corners=True, fuse_online_tick=fuse)
        hist = run_driver(ReplayDriver(short), tracked, device="cpu")
        est = np.asarray(hist.est_poses)
        assert est.shape == (6, 3) and np.isfinite(est).all(), fuse
        assert set(hist.stage_seconds) == ({"tick"} if fuse else {"icp_refine", "tick"})
    for kw in ({"proposal_mode": "fastslam2"},
               {"use_icp_proposal": True},
               {"proposal_mode": "fastslam2", "use_icp_proposal": True,
                "adaptive_proposal_floors": True}):
        hist = replay_chunked(short, cfg.replace(**kw), chunk_size=4, device="cpu")
        assert len(hist.est_poses) == 6 and np.isfinite(np.asarray(hist.est_poses)).all()


def test_cli_records_and_runs_on_the_cpu(tmp_path, capsys):
    """``record``, then ``run --chunk``, ``run`` (the online loop) and
    ``sim`` on an explicit CPU device, and ``run`` on the log saved as
    ``.fslog``."""
    log_path = str(tmp_path / "log.npz")
    assert cli.main(["record", "--ticks", "20", "--out", log_path, "--seed", "3"]) == 0
    assert len(LaserLog.load(log_path)) == 20
    capsys.readouterr()
    small = ["--particles", "64", "--landmarks", "16", "--warmup", "4", "--device", "cpu"]
    for argv in (["run", "--log", log_path, "--chunk", "8"], ["run", "--log", log_path],
                 ["run", "--log", log_path, "--production"], ["sim", "--ticks", "12"]):
        assert cli.main(argv + small) == 0, argv
        out = capsys.readouterr().out
        assert '"ate_rmse_m"' in out and '"device": "cpu"' in out, argv
    # an .fslog log (the FSLG1 codec) loads back equal and runs as well
    fslog = str(tmp_path / "log.fslog")
    LaserLog.load(log_path).save(fslog)
    back, want = LaserLog.load(fslog), LaserLog.load(log_path)
    np.testing.assert_allclose(back.scans, want.scans, rtol=1e-6)   # stored as float32
    np.testing.assert_array_equal(back.gt_poses, want.gt_poses)
    assert cli.main(["run", "--log", fslog] + small) == 0
    assert '"ate_rmse_m"' in capsys.readouterr().out
