"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a GPU these tests skip.  They import no JAX, so on
a machine with a GPU and no JAX they run without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels, kernels
from fastslam_tpu_torch.core.state import init_planes_state, pad_measurements

pytestmark = pytest.mark.cuda

P, L, M, C = 3000, 16, 8, 6   # P not a multiple of the block: a ragged edge


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def seeded(cfg, device, seed):
    """A state with landmarks from two plain ticks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ms = pad_measurements(cfg, [(1.5 + 0.4 * i, -2.0 + 0.6 * i) for i in range(6)],
                          device)
    state = init_planes_state(cfg, device)
    for _ in range(2):
        d = kernels.draw(gen, cfg.num_particles)
        poses = kernels.propagate_particles(
            state.poses, 0.0, 0.4, 0.01 * d.rot, 0.05 * d.trans)
        cuda_kernels.fused_update_planes_ref(
            poses, state.log_weights, state.lm_mx, state.lm_my, state.lm_ca,
            state.lm_cb, state.lm_cc, state.lm_cd, state.lm_count,
            ms.range_bearing, ms.valid, cfg)
        state = state.replace(poses=poses)
    return state, ms, gen


def planes(s):
    return (s.log_weights, s.lm_mx, s.lm_my, s.lm_ca, s.lm_cb, s.lm_cc, s.lm_cd,
            s.lm_count)


@pytest.mark.parametrize("parity", [False, True])
def test_per_tick_kernel_matches_plain(device, parity):
    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                         parity_mode=parity)
    state, ms, _ = seeded(cfg, device, 0)
    ms = ms._replace(valid=ms.valid.clone())
    ms.valid[2] = False                               # interior hole
    sk, sp = state.clone(), state.clone()
    before = cuda_kernels.LAUNCHES["fused_update_planes"]
    got = cuda_kernels.fused_update_planes(state.poses, *planes(sk),
                                           ms.range_bearing, ms.valid, cfg)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["fused_update_planes"] == before + 1
    want = cuda_kernels.fused_update_planes_ref(state.poses, *planes(sp),
                                                ms.range_bearing, ms.valid, cfg)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            # -fmad=false: the kernel rounds op for op like the plain version
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_chunked_kernel_matches_plain(device):
    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                         parity_mode=False)
    state, ms, gen = seeded(cfg, device, 1)
    d = kernels.draw(gen, P, C)
    rotating = (torch.arange(C, device=device) % 3 == 2)[:, None]
    noisy_rot = torch.where(rotating, 0.3 + 0.01 * d.rot, 0.0)
    noisy_trans = torch.where(rotating, 0.0, 0.4 + 0.05 * d.trans)
    z = ms.range_bearing[None].expand(C, M, 2).contiguous()
    zv = ms.valid[None].expand(C, M).contiguous()
    sk, sp = state.clone(), state.clone()
    got = cuda_kernels.fused_update_planes_multi(
        state.poses, state.log_weights, *planes(sk)[1:], z, zv, noisy_rot,
        noisy_trans, cfg)
    torch.cuda.synchronize()
    want = cuda_kernels.fused_update_planes_multi_ref(
        state.poses, state.log_weights, *planes(sp)[1:], z, zv, noisy_rot,
        noisy_trans, cfg)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_kernel_wrappers_refuse_bad_inputs(device):
    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                         parity_mode=False)
    state, ms, _ = seeded(cfg, device, 2)
    args = list(planes(state))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.fused_update_planes(
            state.poses, args[0], args[1].t().contiguous().t(), *args[2:],
            ms.range_bearing, ms.valid, cfg)
    with pytest.raises(ValueError, match="float32"):
        cuda_kernels.fused_update_planes(
            state.poses.double(), *args, ms.range_bearing, ms.valid, cfg)
    with pytest.raises(ValueError, match="parity mode needs"):
        cuda_kernels.fused_update_planes(
            state.poses, *args, ms.range_bearing, ms.valid,
            cfg.replace(parity_mode=True))


def test_main_path_runs_through_the_kernels(device):
    from fastslam_tpu_torch.app.runner import replay_chunked
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld

    log = record_log(SimWorld(seed=3), num_ticks=52)
    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, parity_mode=False,
                         warmup_iterations=8)
    before = dict(cuda_kernels.LAUNCHES)
    hist = replay_chunked(log, cfg, chunk_size=8, device=device)
    assert cuda_kernels.LAUNCHES["fused_update_planes_multi"] == before["fused_update_planes_multi"] + 6
    assert cuda_kernels.LAUNCHES["fused_update_planes"] == before["fused_update_planes"] + 4
    assert np.isfinite(np.asarray(hist.est_poses)).all()
    assert hist.metrics()["ate_rmse_m"] < 0.1
