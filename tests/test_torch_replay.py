"""The slice as a whole: the port's ``replay_chunked`` against the JAX one
(Pallas interpret mode) on a recorded 48-tick synthetic drive, P=128, L=16.

``warmup_iterations=8``: the default 150 would overwrite every estimate with
dead reckoning.  Without motion noise both runs are deterministic (all
particles stay identical, so nothing resamples and the draws do not matter)
and the estimates agree per tick at 1e-4.  With noise the two random streams
differ, so both are held to the accuracy bar instead.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fastslam_tpu.app.runner import replay_chunked as jax_replay_chunked
from fastslam_tpu.config import FastSLAMConfig as JaxConfig

from fastslam_tpu_torch.app import cli
from fastslam_tpu_torch.app.runner import replay_chunked
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


def test_replay_refuses_paths_not_ported(drive):
    cfg = config_from_jax_fields(dataclasses.asdict(jax_config()))
    with pytest.raises(ValueError, match="production"):
        replay_chunked(drive, cfg.replace(parity_mode=True), device="cpu")
    for kw in ({"use_icp_proposal": True}, {"adaptive_proposal_floors": True},
               {"proposal_mode": "fastslam2"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            replay_chunked(drive, cfg.replace(**kw), device="cpu")


def test_cli_records_and_runs_on_the_cpu(tmp_path, capsys):
    """``record`` then ``run --chunk`` on an explicit CPU device; ``run``
    without ``--chunk`` is not ported yet."""
    log_path = str(tmp_path / "log.npz")
    assert cli.main(["record", "--ticks", "20", "--out", log_path, "--seed", "3"]) == 0
    assert len(LaserLog.load(log_path)) == 20
    capsys.readouterr()
    assert cli.main(["run", "--log", log_path, "--chunk", "8", "--particles", "64",
                     "--landmarks", "16", "--warmup", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"ate_rmse_m"' in out and '"device": "cpu"' in out
    with pytest.raises(NotImplementedError, match="online"):
        cli.main(["run", "--log", log_path, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="fslog"):
        LaserLog.load(str(tmp_path / "log.fslog"))
