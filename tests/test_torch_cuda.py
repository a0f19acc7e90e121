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


def fs2_config(evidence):
    return FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                          parity_mode=False, proposal_mode="fastslam2",
                          fs2_evidence_weights=evidence)


def assert_fs2_close(got, want):
    """fs2 kernel vs plain: floats at atol = rtol = 1e-4, counts exact."""
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        elif w.dtype == torch.int32:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("evidence", [False, True])
def test_fs2_per_tick_kernel_matches_plain(device, evidence):
    cfg = fs2_config(evidence)
    state, ms, gen = seeded(cfg, device, 3)
    ms = ms._replace(valid=ms.valid.clone())
    ms.valid[2] = False                               # interior hole
    d = kernels.draw(gen, P, fs2=True)
    zero = torch.zeros(P, device=device)
    pred = kernels.propagate_particles(state.poses, 0.0, 0.4, zero, zero)
    _, _, s_t2, s_r2, fxy = kernels.fs2_prior_scalars(
        torch.tensor(0.0, device=device), torch.tensor(0.4, device=device), cfg)
    sk, sp = state.clone(), state.clone()
    before = cuda_kernels.LAUNCHES["fused_fs2_planes"]
    got = cuda_kernels.fused_fs2_planes(pred, *planes(sk), ms.range_bearing, ms.valid,
                                        d.noise, s_t2, s_r2, fxy, cfg, evidence_scale=0.37)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["fused_fs2_planes"] == before + 1
    want = cuda_kernels.fused_fs2_planes_ref(pred, *planes(sp), ms.range_bearing,
                                             ms.valid, d.noise, s_t2, s_r2, fxy, cfg,
                                             evidence_scale=0.37)
    assert_fs2_close(got, want)
    assert bool((want[-1] > state.lm_count).any())    # appended
    assert bool((want[1] != state.log_weights).any())  # weighted


@pytest.mark.parametrize("evidence", [False, True])
def test_fs2_chunked_kernel_matches_plain(device, evidence):
    cfg = fs2_config(evidence)
    state, ms, gen = seeded(cfg, device, 4)
    d = kernels.draw(gen, P, C, fs2=True)
    rotating = torch.arange(C, device=device) % 3 == 2
    rots = torch.where(rotating, 0.3, 0.0)
    trans = torch.where(rotating, 0.0, 0.4)
    floors = (torch.linspace(0.005, 0.02, C, device=device),
              torch.linspace(0.01, 0.003, C, device=device))
    dial = torch.where(torch.arange(C, device=device) % 2 == 1, 0.37, 1.0)
    rot_eff, trans_eff, s_t2, s_r2, fxy = kernels.fs2_prior_scalars(rots, trans, cfg, floors)
    z = ms.range_bearing[None].expand(C, M, 2).contiguous()
    zv = ms.valid[None].expand(C, M).contiguous()
    sk, sp = state.clone(), state.clone()
    args = (d.noise, rot_eff, trans_eff, s_t2, s_r2, fxy, cfg)
    got = cuda_kernels.fused_fs2_planes_multi(state.poses, state.log_weights,
                                              *planes(sk)[1:], z, zv, *args,
                                              evidence_scale=dial)
    torch.cuda.synchronize()
    want = cuda_kernels.fused_fs2_planes_multi_ref(state.poses, state.log_weights,
                                                   *planes(sp)[1:], z, zv, *args,
                                                   evidence_scale=dial)
    assert_fs2_close(got, want)


def small_log(num_ticks=52):
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld

    return record_log(SimWorld(seed=3), num_ticks=num_ticks)


def test_fs2_replay_runs_through_the_fs2_kernels(device):
    from fastslam_tpu_torch.app.runner import replay_chunked

    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, parity_mode=False,
                         proposal_mode="fastslam2", warmup_iterations=8)
    before = dict(cuda_kernels.LAUNCHES)
    hist = replay_chunked(small_log(), cfg, chunk_size=8, device=device)
    delta = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert delta == {"fused_update_planes": 0, "fused_update_planes_multi": 0,
                     "fused_fs2_planes": 4, "fused_fs2_planes_multi": 6}
    assert np.isfinite(np.asarray(hist.est_poses)).all()
    assert hist.metrics()["ate_rmse_m"] < 0.25


def test_frontend_gives_the_same_measurements_twice(device):
    from fastslam_tpu_torch.app.runner import scan_points
    from fastslam_tpu_torch.frontend.pipeline import scan_to_measurements

    cfg = FastSLAMConfig(parity_mode=False)
    pts, valid = scan_points(small_log(40))
    pts, valid = torch.from_numpy(pts).to(device), torch.from_numpy(valid).to(device)
    runs = [[scan_to_measurements(pts[t], valid[t], cfg) for t in range(len(pts))]
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a.range_bearing, b.range_bearing)
        assert torch.equal(a.valid, b.valid)
    assert sum(int(m.valid.sum()) for m in runs[0]) > 0


@pytest.mark.parametrize("proposal_mode", ["motion", "fastslam2"])
def test_replay_gives_the_same_estimates_twice(device, proposal_mode):
    from fastslam_tpu_torch.app.runner import replay_chunked

    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, parity_mode=False,
                         proposal_mode=proposal_mode, warmup_iterations=8)
    log = small_log()
    a, b = (np.asarray(replay_chunked(log, cfg, chunk_size=8, rng=5,
                                      device=device).est_poses) for _ in range(2))
    np.testing.assert_array_equal(a, b)


def test_resample_cumsum_is_the_same_on_every_run_and_on_the_cpu(device):
    w = torch.rand(100_000, generator=torch.Generator().manual_seed(0))
    w /= w.sum()
    on_cpu = kernels.fixed_order_cumsum(w)
    for _ in range(4):
        assert torch.equal(kernels.fixed_order_cumsum(w.to(device)).cpu(), on_cpu)
