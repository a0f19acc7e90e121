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
from fastslam_tpu_torch.core.cuda_kernels import filter as filter_kernels
from fastslam_tpu_torch.core.cuda_kernels import icp as icp_kernels
from fastslam_tpu_torch.core.cuda_kernels import ring as ring_kernels
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
    # -fmad=false: the staged kernel rounds op for op like the plain version
    assert_fs2_equal(got, want)


@pytest.mark.parametrize("parity", [False, True])
def test_chunked_kernel_matches_plain(device, parity):
    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                         parity_mode=parity)
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
    # -fmad=false, and the kernel's cosf/sinf equal torch.cos/torch.sin
    assert_fs2_equal(got, want)


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


def assert_fs2_equal(got, want):
    """fs2 kernel vs plain: every output bit for bit (-fmad=false, the same
    operations in the same order)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and torch.equal(g, w)


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
    assert_fs2_equal(got, want)
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
    assert_fs2_equal(got, want)


FS2_P, FS2_M, FS2_C = 1000, 16, 6      # 1000 particles: a ragged last tile
FS2_Z = [(1.0 + 0.35 * k, -2.8 + 0.37 * k) for k in range(FS2_M)]


def ragged_fs2_inputs(device, l, evidence, seed):
    """A planes state whose tiles mix every count from 0 to L (a fifth of the
    particles two slots short of a full map, some full), slots 0..7 holding
    landmarks at the first measurements' world points (matches), the rest
    scattered (appends); the chunk's draws, prior and dial."""
    rng = np.random.default_rng(seed)
    p = FS2_P
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=l, max_measurements=FS2_M,
                         parity_mode=False, proposal_mode="fastslam2",
                         fs2_evidence_weights=evidence)
    counts = rng.integers(0, l + 1, p)
    counts[::5] = max(l - 2, 0)
    counts[::13] = l
    means = rng.uniform(-9.0, 9.0, (2, l, p))
    for k in range(min(l, 8)):
        r, b = FS2_Z[2 * k]
        means[:, k] = np.array([r * np.cos(b), r * np.sin(b)])[:, None] \
            + rng.normal(0.0, 0.03, (2, p))
    a, d = rng.uniform(0.02, 0.2, (2, l, p))
    b = rng.uniform(-0.01, 0.01, (l, p))
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    state = init_planes_state(cfg, device).replace(
        poses=f32(rng.normal(0.0, 0.05, (p, 3))),
        log_weights=f32(np.log(rng.dirichlet(np.ones(p)))),
        lm_mx=f32(means[0]), lm_my=f32(means[1]), lm_ca=f32(a), lm_cb=f32(b),
        lm_cd=f32(d), lm_count=torch.from_numpy(counts.astype(np.int32)).to(device))
    z = torch.tensor(FS2_Z, dtype=torch.float32, device=device)
    zv = torch.ones(FS2_M, dtype=torch.bool, device=device)
    zv[3] = False                                      # an interior hole
    noise = f32(rng.normal(size=(FS2_C, 3, p)))
    rotating = torch.arange(FS2_C, device=device) % 3 == 2
    prior = kernels.fs2_prior_scalars(
        torch.where(rotating, 0.3, 0.0), torch.where(rotating, 0.0, 0.4), cfg,
        (torch.linspace(0.005, 0.02, FS2_C, device=device),
         torch.linspace(0.01, 0.003, FS2_C, device=device)))
    dial = torch.where(torch.arange(FS2_C, device=device) % 2 == 1, 0.37, 1.0)
    return cfg, state, z, zv, noise, prior, dial


def run_fs2(kernel, fn, state, z, zv, noise, prior, dial, cfg):
    """One call of a per-tick (the chunk's first tick) or chunked fs2
    function on a copy of ``state``."""
    s = state.clone()
    if kernel == "tick":
        zero = torch.zeros(FS2_P, device=s.poses.device)
        pred = kernels.propagate_particles(s.poses, 0.0, 0.4, zero, zero)
        return fn(pred, *planes(s), z, zv, noise[0].t().contiguous(), prior[2][0],
                  prior[3][0], prior[4][0], cfg, evidence_scale=dial[0])
    c = noise.shape[0]
    return fn(s.poses, s.log_weights, *planes(s)[1:], z[None].expand(c, -1, -1).contiguous(),
              zv[None].expand(c, -1).contiguous(), noise, *prior, cfg,
              evidence_scale=dial)


FS2_FUNCTIONS = {"tick": (cuda_kernels.fused_fs2_planes, cuda_kernels.fused_fs2_planes_ref),
                 "chunk": (cuda_kernels.fused_fs2_planes_multi,
                           cuda_kernels.fused_fs2_planes_multi_ref)}


@pytest.mark.parametrize("evidence", [False, True])
@pytest.mark.parametrize("l", [16, 64, 256])
@pytest.mark.parametrize("kernel", ["tick", "chunk"])
def test_fs2_kernels_equal_plain_on_ragged_mixed_tiles(device, kernel, l, evidence):
    """The staged tiles bit for bit: a ragged last tile, tiles of mixed
    counts (only the slots below a tile's largest count are staged), L up
    to the packed key's 256 (a tile of 32), and (in the chunk) particles
    that fill their map to L: appends into slots never staged, then the
    full map's refusal."""
    cfg, state, z, zv, noise, prior, dial = ragged_fs2_inputs(device, l, evidence, l)
    first = state.lm_count[:cuda_kernels.fs2_launch_geometry(l, FS2_M)[0]]
    assert int(first.min()) < int(first.max())          # one tile, mixed counts
    kernel_fn, plain_fn = FS2_FUNCTIONS[kernel]
    got = run_fs2(kernel, kernel_fn, state, z, zv, noise, prior, dial, cfg)
    torch.cuda.synchronize()
    want = run_fs2(kernel, plain_fn, state, z, zv, noise, prior, dial, cfg)
    assert_fs2_equal(got, want)
    before, after = state.lm_count, want[-1]
    assert bool((after > before).any())                 # appended
    if kernel == "chunk":
        filled = (before < l) & (after == l)
        assert bool(filled.any())                        # a map filled to L
        assert bool(((before == l) & (after == l)).any())  # full maps refused appends


@pytest.mark.parametrize("geometry", [(32, 1), (32, 4), (64, 1), (64, 4), (128, 2),
                                      (32, 8)])
@pytest.mark.parametrize("kernel", ["tick", "chunk"])
def test_fs2_kernels_equal_plain_at_every_geometry(device, monkeypatch, kernel, geometry):
    """The results do not depend on the tile or the lanes per particle."""
    cfg, state, z, zv, noise, prior, dial = ragged_fs2_inputs(device, 64, True, 7)
    kernel_fn, plain_fn = FS2_FUNCTIONS[kernel]
    monkeypatch.setattr(filter_kernels, "FS2_TILE", geometry[0])
    monkeypatch.setattr(filter_kernels, "FS2_LANES", geometry[1])
    got = run_fs2(kernel, kernel_fn, state, z, zv, noise, prior, dial, cfg)
    torch.cuda.synchronize()
    assert_fs2_equal(got, run_fs2(kernel, plain_fn, state, z, zv, noise, prior, dial, cfg))


MOTION_P, MOTION_M = 1000, 16       # 1000 particles: a ragged last tile


def ragged_motion_inputs(device, l, parity, seed):
    """A planes state whose tiles mix every count from 0 to L (a fifth two
    slots short of a full map, some full), slots 0..7 near the first
    measurements' points (matches), the rest scattered (appends), asymmetric
    covariances in parity mode; the tick's poses and measurements."""
    rng = np.random.default_rng(seed)
    p = MOTION_P
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=l, max_measurements=MOTION_M,
                         parity_mode=parity)
    counts = rng.integers(0, l + 1, p)
    counts[::5] = max(l - 2, 0)
    counts[::13] = l
    means = rng.uniform(-9.0, 9.0, (2, l, p))
    for k in range(min(l, 8)):
        r, b = FS2_Z[2 * k]
        means[:, k] = np.array([r * np.cos(b), r * np.sin(b)])[:, None] \
            + rng.normal(0.0, 0.03, (2, p))
    a, d = rng.uniform(0.02, 0.2, (2, l, p))
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    state = init_planes_state(cfg, device).replace(
        log_weights=f32(np.log(rng.dirichlet(np.ones(p)))),
        lm_mx=f32(means[0]), lm_my=f32(means[1]), lm_ca=f32(a),
        lm_cb=f32(rng.uniform(-0.01, 0.01, (l, p))),
        lm_cc=f32(rng.uniform(-0.01, 0.01, (l, p))) if parity else None, lm_cd=f32(d),
        lm_count=torch.from_numpy(counts.astype(np.int32)).to(device))
    z = torch.tensor(FS2_Z, dtype=torch.float32, device=device)
    zv = torch.ones(MOTION_M, dtype=torch.bool, device=device)
    zv[3] = False                                      # an interior hole
    return cfg, state, f32(rng.normal(0.0, 0.05, (p, 3))), z, zv


def run_motion(fn, cfg, state, poses, z, zv):
    return fn(poses, *planes(state.clone()), z, zv, cfg)


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("l", [16, 64, 256])
def test_motion_tick_kernel_equals_plain_on_ragged_mixed_tiles(device, l, parity):
    """The staged per-tick motion kernel bit for bit: a ragged last tile,
    tiles of mixed counts, L up to 256 (parity's seven planes still in a
    tile of 32), and (L = 16, 64) maps that fill to L within the tick."""
    cfg, state, poses, z, zv = ragged_motion_inputs(device, l, parity, l + parity)
    tile = cuda_kernels.motion_launch_geometry(l, MOTION_M, parity)[0]
    assert int(state.lm_count[:tile].min()) < int(state.lm_count[:tile].max())
    got = run_motion(cuda_kernels.fused_update_planes, cfg, state, poses, z, zv)
    torch.cuda.synchronize()
    want = run_motion(cuda_kernels.fused_update_planes_ref, cfg, state, poses, z, zv)
    assert_fs2_equal(got, want)
    before, after = state.lm_count, want[-1]
    if l < 256:     # at 256 the scattered landmarks match what would append
        assert bool(((before < l) & (after == l)).any())   # a map filled to L
    assert bool((after > before).any())                    # appended
    assert bool((want[0] != state.log_weights).any())      # weighted


@pytest.mark.parametrize("geometry", [(16, 8), (32, 2), (32, 4), (32, 8), (64, 4), (8, 4),
                                      (16, 16)])
@pytest.mark.parametrize("parity", [False, True])
def test_motion_tick_kernel_equals_plain_at_every_geometry(device, monkeypatch, parity,
                                                           geometry):
    """The results do not depend on the tile or the lanes per particle."""
    cfg, state, poses, z, zv = ragged_motion_inputs(device, 64, parity, 7)
    monkeypatch.setattr(filter_kernels, "MOTION_TILE", geometry[0])
    monkeypatch.setattr(filter_kernels, "MOTION_LANES", geometry[1])
    got = run_motion(cuda_kernels.fused_update_planes, cfg, state, poses, z, zv)
    torch.cuda.synchronize()
    assert_fs2_equal(got, run_motion(cuda_kernels.fused_update_planes_ref, cfg, state,
                                     poses, z, zv))


MOTION_C = 6


def ragged_motion_chunk(device, l, parity, seed):
    """The ragged state of :func:`ragged_motion_inputs` and a chunk of
    MOTION_C ticks: every third tick rotates, the others translate 0.4 m, so
    the same measurements land elsewhere on each tick (appends that later
    ticks scan again, maps that fill to L)."""
    cfg, state, _, z, zv = ragged_motion_inputs(device, l, parity, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = kernels.draw(gen, MOTION_P, MOTION_C)
    rotating = (torch.arange(MOTION_C, device=device) % 3 == 2)[:, None]
    noisy_rot = torch.where(rotating, 0.3 + 0.01 * d.rot, 0.0)
    noisy_trans = torch.where(rotating, 0.0, 0.4 + 0.05 * d.trans)
    return (cfg, state, z[None].expand(MOTION_C, -1, -1).contiguous(),
            zv[None].expand(MOTION_C, -1).contiguous(), noisy_rot, noisy_trans)


def run_motion_chunk(fn, cfg, state, z, zv, noisy_rot, noisy_trans):
    s = state.clone()
    return fn(s.poses, s.log_weights, *planes(s)[1:], z, zv, noisy_rot, noisy_trans, cfg)


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("l", [16, 64, 256])
def test_motion_chunked_kernel_equals_plain_on_ragged_mixed_tiles(device, l, parity):
    """The chunked motion kernel's tile, staged once for the chunk, bit for
    bit: a ragged last tile, tiles of mixed counts, slots appended on one
    tick and scanned on the next from shared memory, maps filling to L."""
    args = ragged_motion_chunk(device, l, parity, l + parity)
    state = args[1]
    tile = cuda_kernels.motion_launch_geometry(l, MOTION_M, parity)[0]
    assert int(state.lm_count[:tile].min()) < int(state.lm_count[:tile].max())
    got = run_motion_chunk(cuda_kernels.fused_update_planes_multi, *args)
    torch.cuda.synchronize()
    want = run_motion_chunk(cuda_kernels.fused_update_planes_multi_ref, *args)
    assert_fs2_equal(got, want)
    before, after = state.lm_count, want[-1]
    assert bool(((before < l) & (after == l)).any())       # a map filled to L
    assert bool((want[3][-1] != state.log_weights).any())  # weighted


def test_motion_chunked_kernel_equals_plain_with_tiles_below_32(device):
    """Parity at L = 512: seven planes fit a tile of 16 particles."""
    args = ragged_motion_chunk(device, 512, True, 5)
    assert cuda_kernels.motion_launch_geometry(512, MOTION_M, True)[0] < 32
    got = run_motion_chunk(cuda_kernels.fused_update_planes_multi, *args)
    torch.cuda.synchronize()
    assert_fs2_equal(got, run_motion_chunk(cuda_kernels.fused_update_planes_multi_ref, *args))


@pytest.mark.parametrize("geometry", [(16, 8), (32, 2), (32, 8), (64, 4), (8, 4), (16, 16)])
@pytest.mark.parametrize("parity", [False, True])
def test_motion_chunked_kernel_equals_plain_at_every_geometry(device, monkeypatch, parity,
                                                              geometry):
    """The chunk's results do not depend on the tile or the lanes."""
    args = ragged_motion_chunk(device, 64, parity, 7)
    monkeypatch.setattr(filter_kernels, "MOTION_TILE", geometry[0])
    monkeypatch.setattr(filter_kernels, "MOTION_LANES", geometry[1])
    got = run_motion_chunk(cuda_kernels.fused_update_planes_multi, *args)
    torch.cuda.synchronize()
    assert_fs2_equal(got, run_motion_chunk(cuda_kernels.fused_update_planes_multi_ref, *args))


def fused_icp_inputs(device, b, n, mt, seed):
    """Random cloud pairs: the source a moved copy of part of the target
    (so ICP converges), duplicate targets (ties), a tenth of the targets and
    source points invalid, the last pair's target all invalid; the target's
    normals as the proposal computes them."""
    from fastslam_tpu_torch.proposal.icp import estimate_normals, rotate_points

    gen = torch.Generator(device=device).manual_seed(seed)
    tgt = torch.randn((b, mt, 2), generator=gen, device=device) * 3.0
    if mt > 3:
        tgt[:, mt // 2:mt // 2 + mt // 4] = tgt[:, :mt // 4]            # ties
    take = torch.randint(0, mt, (b, n), generator=gen, device=device)
    src = torch.gather(tgt, 1, take[..., None].expand(b, n, 2))
    src = rotate_points(src, 0.03) + 0.05 + 0.01 * torch.randn(
        (b, n, 2), generator=gen, device=device)
    tv = torch.rand((b, mt), generator=gen, device=device) < 0.9
    sv = torch.rand((b, n), generator=gen, device=device) < 0.9
    tv[-1] = False
    normals, n_ok = estimate_normals(tgt, tv)
    return src.contiguous(), tgt, sv, tv, normals.contiguous(), n_ok.contiguous()


def assert_icp_equal(got, want):
    """theta, translation, mean error (NaN where the plain version has NaN)
    and iterations bit for bit."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.is_floating_point():
            nan = torch.isnan(w)
            assert torch.equal(torch.isnan(g), nan)
            assert torch.equal(g[~nan], w[~nan])
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("b,n,mt,tol", [(37, 180, 180, 1e-5), (2, 180, 180, 1e-5),
                                        (5, 7, 9, 1e-5), (1, 1, 1, 1e-5),
                                        (3, 180, 180, 0.0), (2, 300, 2500, 1e-5),
                                        (2, 2000, 700, 1e-5)])
def test_fused_icp_kernel_matches_plain(device, b, n, mt, tol):
    """One launch per call, every output bit for bit: batches of 180-point
    scans (37 pairs, the online 2), tiny clouds (sums padded to 8 and to 1),
    pairs held to max_iter (tol 0), targets across several shared-memory
    tiles (2500), and per-point arrays in device-memory scratch (2000
    points); each batch's last target all invalid (a NaN mean error)."""
    args = fused_icp_inputs(device, b, n, mt, b * n + mt)
    before = cuda_kernels.LAUNCHES["icp_point_to_line"]
    got = cuda_kernels.icp_point_to_line_fused(*args, 100, tol)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["icp_point_to_line"] == before + 1
    want = cuda_kernels.icp_point_to_line_ref(*args, 100, tol)
    assert_icp_equal(got, want)
    assert int(got[3][-1]) == 100 and bool(torch.isnan(got[2][-1]))
    if tol == 0.0:
        assert bool((got[3] == 100).all())


@pytest.mark.parametrize("geometry", [(32, 1), (128, 4), (256, 8), (512, 16), (1024, 32)])
def test_fused_icp_kernel_equals_plain_at_every_geometry(device, monkeypatch, geometry):
    args = fused_icp_inputs(device, 9, 180, 180, 3)
    monkeypatch.setattr(icp_kernels, "ICP_THREADS", geometry[0])
    monkeypatch.setattr(icp_kernels, "ICP_LANES", geometry[1])
    got = cuda_kernels.icp_point_to_line_fused(*args, 100, 1e-5)
    torch.cuda.synchronize()
    assert_icp_equal(got, cuda_kernels.icp_point_to_line_ref(*args, 100, 1e-5))


def test_fused_icp_rotation_is_torch_trig(device):
    """The kernel's sinf/cosf (built with -fmad=false) equal torch.sin and
    torch.cos of a CUDA tensor bit for bit."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = (torch.rand(4_000_000, generator=gen, device=device) * 2 - 1) * 4 * np.pi
    x = torch.cat([x, torch.tensor([0.0, -0.0, np.pi, -np.pi, 1e30, -1e30, 1e-45],
                                   device=device)])
    s, c = cuda_kernels.icp_rotation_sin_cos(x)
    torch.cuda.synchronize()
    assert torch.equal(s, torch.sin(x)) and torch.equal(c, torch.cos(x))


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
    assert delta == {k: {"fused_fs2_planes": 4, "fused_fs2_planes_multi": 6}.get(k, 0)
                     for k in before}
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


@pytest.mark.parametrize("b,n,mt", [(37, 180, 180), (3, 300, 2500), (1, 5, 1),
                                    (70_000, 4, 6), (2, 65_535 * 128 + 200, 3)])
def test_icp_kernel_matches_plain(device, b, n, mt):
    """Batched pairs, ragged source tiles, targets across several shared-memory
    tiles, duplicate targets (ties) and one all-invalid target cloud: indices
    equal and distances bit for bit.  Also more pairs, and more source tiles
    of one cloud, than a grid dimension of 65535 blocks holds, in one launch."""
    gen = torch.Generator(device=device).manual_seed(b)
    src = torch.randn((b, n, 2), generator=gen, device=device) * 3.0
    tgt = torch.randn((b, mt, 2), generator=gen, device=device) * 3.0
    valid = torch.rand((b, mt), generator=gen, device=device) < 0.8
    if mt > 1:
        tgt[:, mt // 2:mt // 2 + mt // 4] = tgt[:, :mt // 4]   # ties
        src[:, 0] = tgt[:, 0]                                  # distance 0
    valid[b // 2] = False                                      # no valid target
    before = cuda_kernels.LAUNCHES["icp_correspondences"]
    got = cuda_kernels.icp_correspondences(src, tgt, valid)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["icp_correspondences"] == before + 1
    want = cuda_kernels.icp_correspondences_ref(src, tgt, valid)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    assert bool(torch.isinf(got[0][b // 2]).all()) and bool((got[1][b // 2] == 0).all())


def test_icp_and_adaptive_paths_run_through_the_kernels(device):
    from fastslam_tpu_torch.app.runner import replay_chunked, run_driver
    from fastslam_tpu_torch.drivers.replay import ReplayDriver

    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, parity_mode=False,
                         proposal_mode="fastslam2", use_icp_proposal=True,
                         adaptive_proposal_floors=True, icp_blend=0.0,
                         warmup_iterations=8)
    log = small_log()
    before = dict(cuda_kernels.LAUNCHES)
    runs = [replay_chunked(log, cfg, chunk_size=8, device=device) for _ in range(2)]
    delta = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert delta["fused_fs2_planes_multi"] == 12 and delta["fused_fs2_planes"] == 8
    # the ICP stage is one fused call per replay; the search alone never runs
    assert delta["icp_point_to_line"] == 2 and delta["icp_correspondences"] == 0
    a, b = (np.asarray(h.est_poses) for h in runs)
    np.testing.assert_array_equal(a, b)
    assert runs[0].metrics()["ate_rmse_m"] < 0.25
    before = dict(cuda_kernels.LAUNCHES)
    hist = run_driver(ReplayDriver(small_log(24)), cfg.replace(fuse_online_tick=False),
                      device=device)
    delta = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert delta["fused_fs2_planes"] == 24 and delta["fused_fs2_planes_multi"] == 0
    # the split path: one fused ICP launch per tick with a previous scan
    assert delta["icp_point_to_line"] == 23 and delta["icp_correspondences"] == 0
    assert np.isfinite(np.asarray(hist.est_poses)).all()
    before = dict(cuda_kernels.LAUNCHES)
    hist = run_driver(ReplayDriver(small_log(24)), cfg, device=device)
    delta = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    # the fused tick: one 2-pair ICP launch every tick, 23 graph replays
    assert delta["fused_fs2_planes"] == 24 and delta["icp_point_to_line"] == 24
    assert delta["icp_correspondences"] == 0 and hist.graph_replays == 23
    assert np.isfinite(np.asarray(hist.est_poses)).all()


@pytest.mark.parametrize("from_checkpoint", [True, False])
def test_fused_graph_equals_eager_across_a_forced_health_recovery(device, monkeypatch,
                                                                  tmp_path, from_checkpoint):
    """A health check that reports a non-finite state at tick 14 forces a
    recovery (from the tick-10 checkpoint and its generator, or a
    re-initialization) in the middle of a run through the captured graph:
    the recovery writes into the graph's static state, and the run equals
    the fused tick run eagerly on the card bit for bit."""
    import dataclasses

    from fastslam_tpu_torch.app.runner import run_driver
    from fastslam_tpu_torch.drivers.replay import ReplayDriver
    from fastslam_tpu_torch.utils import health

    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, parity_mode=False,
                         proposal_mode="fastslam2", use_icp_proposal=True,
                         adaptive_proposal_floors=True, icp_blend=0.0, warmup_iterations=8)
    real = health.HealthMonitor.check

    def forced(self, state, pose):
        rep = real(self, state, pose)
        self.checks = getattr(self, "checks", 0) + 1
        if self.checks == 15:
            rep = dataclasses.replace(rep, ok=False, issues=rep.issues + ["nan_or_inf_state"])
        return rep

    monkeypatch.setattr(health.HealthMonitor, "check", forced)
    log = small_log(24)

    def run(graph, **kw):
        ck = str(tmp_path / f"ck_{graph}.npz") if from_checkpoint else None
        return run_driver(ReplayDriver(log), cfg, rng=0, device=device, graph=graph,
                          checkpoint_path=ck, checkpoint_every=10, **kw)

    captured, eager = run(True, health=True), run(False, health=True)
    assert captured.graph_replays == 23 and eager.graph_replays == 0
    got = np.asarray(captured.est_poses)
    np.testing.assert_array_equal(got, np.asarray(eager.est_poses))
    assert np.isfinite(got).all()
    untouched = np.asarray(run(True).est_poses)          # no health check, no recovery
    np.testing.assert_array_equal(untouched[:15], got[:15])
    assert not np.array_equal(untouched[15:], got[15:])


@pytest.mark.parametrize("s,p_local,d", [(1, 2000, 389), (2, 1500, 389), (3, 1001, 389),
                                         (8, 12_501, 389), (8, 333, 5), (3, 1, 5)])
def test_ring_exchange_kernel_matches_plain(device, s, p_local, d):
    """One launch moves every shard's block to both neighbours, exactly as
    the plain copies do: S = 1 (both halos are the block itself), S = 2
    (one neighbour, two buffers), blocks whose size is not a multiple of 4
    floats (the scalar tail) and a block smaller than one float4."""
    gen = torch.Generator(device=device).manual_seed(s * p_local)
    blocks = [torch.randn((p_local, d), generator=gen, device=device) for _ in range(s)]
    before = cuda_kernels.LAUNCHES["ring_halo_exchange"]
    lefts, rights = cuda_kernels.ring_halo_exchange(blocks)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["ring_halo_exchange"] == before + 1
    want_l, want_r = cuda_kernels.ring_halo_exchange_ref(blocks)
    for g, w in zip(lefts + rights, want_l + want_r):
        assert torch.equal(g, w)
    assert torch.equal(lefts[0], blocks[-1]) and torch.equal(rights[-1], blocks[0])


def test_ring_exchange_kernel_refuses_bad_blocks(device):
    blocks = [torch.zeros((64, 389), device=device) for _ in range(3)]
    with pytest.raises(ValueError, match="float32"):      # a block on the CPU
        cuda_kernels.ring_halo_exchange(blocks[:2] + [torch.zeros((64, 389))])
    with pytest.raises(ValueError, match="contiguous"):   # a strided block
        cuda_kernels.ring_halo_exchange(
            [b.t().contiguous().t() for b in blocks])
    with pytest.raises(ValueError, match="float32"):      # another shape
        cuda_kernels.ring_halo_exchange(blocks[:2] + [torch.zeros((63, 389), device=device)])
    with pytest.raises(ValueError, match="aligned"):      # 1 float past an aligned start
        flat = torch.zeros(64 * 389 + 1, device=device)
        cuda_kernels.ring_halo_exchange([flat[1:].view(64, 389)] * 2)
    with pytest.raises(ValueError, match="at most"):
        cuda_kernels.ring_halo_exchange([blocks[0]] * (cuda_kernels.RING_MAX_SHARDS + 1))


@pytest.mark.parametrize("processes,shards", [(2, 2), (2, 1), (4, 1)])
def test_peer_exchange_across_processes_equals_plain(device, processes, shards):
    """Processes on the card joined by gloo: 20 exchanges through the
    cross-process kernel, each on new blocks, each equal to the plain
    exchange bit for bit (the epochs and both buffer sets), and the ring
    resampler on both weight profiles equal to ``resample_state``, with one
    launch per process per call (``probes/check_ring_resample.py``)."""
    from fastslam_tpu_torch.probes import check_ring_resample

    out = check_ring_resample.run(processes, shards, P, L, "cuda", exchanges=20, timeout=300)
    assert out["exchange"] == {"exchanges": 20, "max_abs_err": 0.0, "equal": True,
                               "launches": [20] * processes}
    # 2 resamples, 20 exchanges and 20 back to back in each process
    assert [w["calls"] for w in out["waits"]] == [42] * processes
    for profile in ("healthy", "collapsed"):
        assert set(out["resample"][profile]["max_abs_err"].values()) == {0.0}
        assert out["resample"][profile]["peer_launches"] == [1] * processes
    assert out["ok"]


@pytest.mark.parametrize("processes,shards", [(2, 2), (3, 1)])
def test_peer_exchanges_back_to_back_equal_plain(device, processes, shards):
    """20 exchanges in each process with no call over the group between
    them, so that a process may run a call ahead of its neighbour (the wait
    (a) and both buffer sets): each call's halos, copied as it returns, equal
    the plain exchange of its blocks bit for bit."""
    from fastslam_tpu_torch.probes import check_ring_resample

    out = check_ring_resample.run(processes, shards, P, L, "cuda", exchanges=20, timeout=300)
    assert out["back_to_back"] == {"exchanges": 20, "max_abs_err": 0.0, "equal": True,
                                   "launches": [20] * processes}
    assert out["ok"]


def _run_pair(mode: str, tmp_path, *extra):
    """Run ``mode`` of this file's ``__main__`` in two processes joined by
    gloo on a free port; each must exit 0 within 300 s."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode,
                               str(rank), str(port), str(tmp_path), *map(str, extra)],
                              env={**os.environ, "PYTHONPATH": repo}, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-2000:]
    finally:
        for proc in procs:
            proc.kill()
            proc.wait(timeout=60)


@pytest.mark.parametrize("timeout", [2.0])
def test_peer_exchange_raises_when_a_neighbour_stops_calling(device, tmp_path, timeout):
    """Two processes exchange three times; then process 1 stops calling.
    Process 0's fourth call raises within ``timeout`` and a few seconds,
    naming the call and its wait (c), rather than hang; its stream runs work
    again afterwards, and the ring is refused from then on."""
    import json

    _run_pair("silent", tmp_path, timeout)
    first = json.loads((tmp_path / "silent_0.json").read_text())
    second = json.loads((tmp_path / "silent_1.json").read_text())
    assert "call 4" in first["error"] and "delivered" in first["error"], first["error"]
    assert "still blocked" not in first["error"]
    assert timeout <= first["seconds"] < timeout + 10.0
    assert first["stream_ok"]
    assert "failed earlier" in first["refused"]
    assert (first["launches"], second["launches"]) == (4, 3)


def silent_worker(rank: int, port: int, outdir: str, timeout: float) -> None:
    """One process of ``test_peer_exchange_raises_when_a_neighbour_stops_calling``."""
    import json
    import os
    import time

    import torch.distributed as dist

    from fastslam_tpu_torch.parallel.multihost import initialize_distributed

    initialize_distributed(f"localhost:{port}", 2, rank)
    group = dist.group.WORLD
    gen = torch.Generator(device="cuda").manual_seed(rank)
    blocks = [torch.randn((64, 389), generator=gen, device="cuda") for _ in range(2)]
    for _ in range(3):
        lefts, rights = cuda_kernels.ring_halo_exchange_peers(blocks, group)
        want = cuda_kernels.ring_halo_exchange_peers_ref(blocks, group)
        assert all(torch.equal(g, w) for g, w in zip(lefts + rights, want[0] + want[1]))
    out = {"error": None, "refused": None}
    if rank == 0:
        ring_kernels.PEER_TIMEOUT_S = timeout
        t0 = time.monotonic()
        try:
            cuda_kernels.ring_halo_exchange_peers(blocks, group)
        except RuntimeError as e:
            out["error"] = str(e)
        out["seconds"] = time.monotonic() - t0
        x = torch.arange(1000.0, device="cuda")
        out["stream_ok"] = float((x * 2).sum()) == 999000.0
        try:
            cuda_kernels.ring_halo_exchange_peers(blocks, group)
        except RuntimeError as e:
            out["refused"] = str(e)
    out["launches"] = cuda_kernels.LAUNCHES["ring_halo_exchange_peers"]
    with open(os.path.join(outdir, f"silent_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    cuda_kernels.close_peer_rings()
    dist.barrier()
    dist.destroy_process_group()


def test_peer_ring_raises_when_a_handle_cannot_be_opened(device, tmp_path):
    """Two processes, each given zeroed IPC handles for its neighbour: the
    exchange raises in both (no fallback to the plain exchange), and its
    kernel never launches."""
    import json

    _run_pair("bad-handle", tmp_path)
    for rank in range(2):
        result = json.loads((tmp_path / f"bad_handle_{rank}.json").read_text())
        assert "could not map" in result["error"] and "cudaIpcOpenMemHandle" in result["error"]
        assert result["launches"] == 0


def bad_handle_worker(rank: int, port: int, outdir: str) -> None:
    """One process of ``test_peer_ring_raises_when_a_handle_cannot_be_opened``:
    the ring's all-gather of IPC handles hands back zeros."""
    import json
    import os

    import torch.distributed as dist

    from fastslam_tpu_torch.parallel import collectives
    from fastslam_tpu_torch.parallel.multihost import initialize_distributed

    initialize_distributed(f"localhost:{port}", 2, rank)
    gather = collectives.all_gather
    collectives.all_gather = lambda tensors, dim=0, group=None: torch.zeros_like(
        gather(tensors, dim, group))
    blocks = [torch.randn((64, 389), device="cuda") for _ in range(2)]
    error = None
    try:
        cuda_kernels.ring_halo_exchange_peers(blocks, dist.group.WORLD)
    except RuntimeError as e:
        error = str(e)
    with open(os.path.join(outdir, f"bad_handle_{rank}.json"), "w") as f:
        json.dump({"error": error,
                   "launches": cuda_kernels.LAUNCHES["ring_halo_exchange_peers"]}, f)
    dist.barrier()
    dist.destroy_process_group()


def test_sharded_engine_runs_through_the_kernels(device):
    """The dry run at 4 shards of the card: S launches per tick or chunk of
    the kernel each step names, one exchange launch per ring resample, and
    every step equal to its single-device counterpart bit for bit."""
    from fastslam_tpu_torch.parallel import dryrun

    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                         resample_threshold_frac=1.0)
    ms = pad_measurements(cfg, [(1.5 + 0.4 * i, -2.0 + 0.6 * i) for i in range(6)], device)
    results = dryrun.dryrun_multichip(4, device, config=cfg, chunk=C, ticks=3,
                                      measurements=[(1.5 + 0.4 * i, -2.0 + 0.6 * i)
                                                    for i in range(6)])
    assert results["resample"] == {"ring_launches": 1, "peer_launches": 0, "halo_path": 1}
    single = dryrun.run_steps(cfg, None, device, ms, chunk=C, ticks=3)
    for mode, (layout, _, kernel) in dryrun.MODES.items():
        r = results[mode]
        # dryrun_multichip checked the launches: S per tick or chunk
        assert r["launches"] == {kernel: 4 * (3 if layout in ("blocks", "planes") else 1)}
        assert torch.equal(r["est"], single[mode]["est"]), mode
        for k, v in single[mode]["state"].__dict__.items():
            g = getattr(r["state"], k)
            assert (v is None and g is None) or torch.equal(g, v), (mode, k)


def test_2d_mesh_runs_one_launch_per_particle_row(device):
    """The blocks modes of the dry run on a 4 x 2 mesh of the card: one
    per-tick launch per particle row per tick, every mode equal to the
    single-device step bit for bit; and ``fused_update`` given a row's slot
    blocks equals it given the whole blocks."""
    from fastslam_tpu_torch.parallel import dryrun
    from fastslam_tpu_torch.parallel.mesh import make_mesh

    cfg = FastSLAMConfig(num_particles=P - P % 4, max_landmarks=L, max_measurements=M,
                         resample_threshold_frac=1.0)
    ms = pad_measurements(cfg, [(1.5 + 0.4 * i, -2.0 + 0.6 * i) for i in range(6)], device)
    modes = [m for m, (layout, _, _) in dryrun.MODES.items() if layout == "blocks"]
    mesh = make_mesh(cfg, [device] * 8, map_parallelism=2)
    got = dryrun.run_steps(cfg, None, device, ms, ticks=3, modes=modes, mesh=mesh)
    want = dryrun.run_steps(cfg, None, device, ms, ticks=3, modes=modes)
    for mode in modes:
        assert got[mode]["launches"] == {"fused_update_planes": 4 * 3}, mode
        assert torch.equal(got[mode]["est"], want[mode]["est"]), mode
        for k, v in want[mode]["state"].__dict__.items():
            assert torch.equal(getattr(got[mode]["state"], k), v), (mode, k)
    s = got["blocks fs2"]["state"]
    whole = cuda_kernels.fused_update(s.poses, s.log_weights, s.lm_mean, s.lm_cov, s.lm_count,
                                      ms.range_bearing, ms.valid, cfg)
    split = cuda_kernels.fused_update(s.poses, s.log_weights, s.lm_mean.split(4, 1),
                                      s.lm_cov.split(4, 1), s.lm_count, ms.range_bearing,
                                      ms.valid, cfg)
    assert torch.equal(whole[0], split[0]) and torch.equal(whole[3], split[3])
    assert torch.equal(whole[1], torch.cat(split[1], 1))
    assert torch.equal(whole[2], torch.cat(split[2], 1))


@pytest.mark.parametrize("l,p", [(64, 3001), (3, 2), (8, 1)])
def test_copy_probe_matches_plain(device, l, p):
    """One launch over six planes and a row, equal to ``x + 1``: a plane
    whose size is not a multiple of 4 floats (the scalar tail) and a row
    smaller than one float4."""
    gen = torch.Generator(device=device).manual_seed(p)
    bufs = [torch.randn((l, p), generator=gen, device=device) for _ in range(6)]
    bufs.append(torch.randn((1, p), generator=gen, device=device))
    before = cuda_kernels.LAUNCHES["hbm_copy"]
    got = cuda_kernels.hbm_copy(bufs)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["hbm_copy"] == before + 1
    for g, w in zip(got, cuda_kernels.hbm_copy_ref(bufs)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("l,p,tile,passes", [(64, 3001, 256, 17), (64, 1000, 302, 3),
                                             (5, 77, 32, 0)])
def test_mul_add_probe_matches_plain(device, l, p, tile, passes):
    """Tiles staged in shared memory (up to the 227 KB opt-in at tile 302),
    a ragged last tile, and no pass at all."""
    gen = torch.Generator(device=device).manual_seed(p)
    a, b, c = (torch.randn((l, p), generator=gen, device=device) for _ in range(3))
    got = cuda_kernels.mul_add(a, b, c, passes, tile)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_kernels.mul_add_ref(a, b, c, passes, tile))


@pytest.mark.parametrize("l,p", [(64, 3001), (1, 5)])
def test_fma_chain_probe_matches_plain(device, l, p):
    """``__fmaf_rn`` against the float64 emulation: equal but for rare
    double roundings of one ulp."""
    gen = torch.Generator(device=device).manual_seed(p)
    x = torch.randn((l, p), generator=gen, device=device)
    got = cuda_kernels.fma_chain(x, 16)
    torch.cuda.synchronize()
    want = cuda_kernels.fma_chain_ref(x, 16)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert (got != want).float().mean() < 1e-3


def test_probe_wrappers_refuse_misplaced_inputs(device):
    planes = [torch.zeros((4, 64), device=device) for _ in range(6)]
    with pytest.raises(ValueError, match="aligned"):      # 1 float past an aligned start
        flat = torch.zeros(4 * 64 + 1, device=device)
        cuda_kernels.hbm_copy([flat[1:].view(4, 64)] + planes[1:]
                              + [torch.zeros((1, 64), device=device)])
    with pytest.raises(ValueError, match="float32"):      # a plane on the CPU
        cuda_kernels.mul_add(planes[0], planes[1], torch.zeros((4, 64)))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.fma_chain(torch.zeros((64, 4), device=device).t())


def test_probe_commands_run_on_the_card(device):
    """Both probe entry points at a small size, timed with CUDA events."""
    from fastslam_tpu_torch.probes import hbm_floor, vpu_roofline

    copy = hbm_floor.run(particles=5000, landmarks=16, k=3, device=device)
    vpu = vpu_roofline.run(particles=5000, landmarks=16, passes=8, k=2, tile=128,
                           device=device)
    for out in (copy, vpu):
        assert out["device"] == torch.cuda.get_device_name(0)
    assert copy["copy_ms"] > 0 and vpu["mul_add_ms"] > 0 and vpu["fma_chain_ms"] > 0


def test_fastslam2_facade_launches_the_per_tick_kernel(device):
    from fastslam_tpu_torch import api
    from fastslam_tpu_torch.models import Measurement

    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                         parity_mode=False)
    slam = api.FastSLAM2(cfg, rng=1, device=device)
    before = dict(cuda_kernels.LAUNCHES)
    for _ in range(3):   # a robot at rest sees the same two corners every tick
        pose = slam.iterate(0.0, 0.0, [Measurement(2.0, 0.3), Measurement(3.5, -0.7)])
    delta = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert delta == {k: 3 if k == "fused_update_planes" else 0 for k in before}
    assert np.isfinite(pose).all() and bool((slam.state.lm_count == 2).all())
    assert len(slam.particles[0].landmarks) == 2


@pytest.mark.parametrize("kw", [
    {},                                                             # motion, no ICP
    {"proposal_mode": "fastslam2"},                                 # fs2, config floors
    {"use_icp_proposal": True, "icp_blend": 0.5},                   # one ICP pair per tick
    {"proposal_mode": "fastslam2", "track_corners": True},
])
def test_fused_graph_equals_eager_in_every_mode(device, kw):
    """The fused tick's graph, captured for each production mode the
    online loop runs, replays once per tick after the eager first tick and
    equals the same tick run eagerly on the card bit for bit."""
    from fastslam_tpu_torch.app.runner import run_driver
    from fastslam_tpu_torch.drivers.replay import ReplayDriver

    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, parity_mode=False,
                         warmup_iterations=8, **kw)
    log = small_log(24)
    before = dict(cuda_kernels.LAUNCHES)
    captured = run_driver(ReplayDriver(log), cfg, rng=0, device=device)
    delta = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    eager = run_driver(ReplayDriver(log), cfg, rng=0, device=device, graph=False)
    assert captured.graph_replays == 23 and eager.graph_replays == 0
    step = "fused_fs2_planes" if kernels.uses_fs2(cfg) else "fused_update_planes"
    assert delta[step] == 24
    assert delta["icp_point_to_line"] == (24 if cfg.use_icp_proposal else 0)
    got = np.asarray(captured.est_poses)
    np.testing.assert_array_equal(got, np.asarray(eager.est_poses))
    assert np.isfinite(got).all() and max(captured.num_measurements) > 0


def test_captured_timing_events_time_a_kernel_as_eager_events_do(device):
    """The capture-safe stage marks: external timing events captured in a
    CUDA graph are recorded again by every replay, and time one known
    kernel (a 256 MB in-place scale) as plain events around it eagerly do."""
    from fastslam_tpu_torch.utils import profiling

    x = torch.ones(1 << 26, device=device)
    work = lambda: x.mul_(1.0)
    eager = [profiling.elapsed_ms(work, device) for _ in range(7)]
    marks = profiling.EventMarks(device, stages=("work",))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        marks.start()
        work()
        marks("work")
    replayed = []
    for _ in range(7):
        before = torch.cuda.Event(enable_timing=True)
        before.record()
        graph.replay()
        torch.cuda.synchronize(device)
        replayed.append(marks.stage_ms()["work"])
        # this replay recorded the marks again, after ``before``
        assert before.elapsed_time(marks._ends[None]) >= 0.0
    ratio = float(np.median(replayed) / np.median(eager))
    assert min(replayed) > 0.0 and 0.5 < ratio < 2.0, (replayed, eager)
    assert torch.equal(x, torch.ones_like(x))


@pytest.mark.parametrize("kw", [
    {},
    {"proposal_mode": "fastslam2", "use_icp_proposal": True, "icp_blend": 0.0,
     "adaptive_proposal_floors": True},
])
def test_traced_fused_graph_equals_eager(device, kw):
    """Inside a profiler session the fused tick's graph, marks and counters
    in, replays bit for bit as the untraced eager tick runs, and each
    replay's row holds every stage's device time."""
    from torch.profiler import ProfilerActivity, profile

    from fastslam_tpu_torch.app.runner import run_driver
    from fastslam_tpu_torch.drivers.replay import ReplayDriver
    from fastslam_tpu_torch.utils import profiling

    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, parity_mode=False,
                         warmup_iterations=8, **kw)
    log = small_log(24)
    profiling.TICK_TRACE.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = run_driver(ReplayDriver(log), cfg, rng=0, device=device)
    rows = profiling.TICK_TRACE.rows()
    profiling.TICK_TRACE.clear()
    eager = run_driver(ReplayDriver(log), cfg, rng=0, device=device, graph=False)
    assert traced.graph_replays == 23 and len(rows) == 24
    np.testing.assert_array_equal(np.asarray(traced.est_poses), np.asarray(eager.est_poses))
    stages = (["icp"] if cfg.use_icp_proposal else []) + ["frontend", "update", "resample"]
    for r in rows:
        assert list(r["stages"]) == stages and min(r["stages"].values()) > 0.0
        tick_ms = next(t1 - t0 for n, _, t0, t1 in r["spans"] if n == "tick") * 1e-6
        assert sum(r["stages"].values()) < tick_ms
        assert r["counters"]["resample_due"] in (0.0, 1.0)
        # the iterations ride the float32 read-back as their bits
        iters = r["counters"].get("icp_iters", 1.0)
        assert 1.0 <= iters <= cfg.icp_max_iterations and 2 * iters == int(2 * iters)


def test_untraced_and_traced_replays_interleave_bit_for_bit(device):
    """The fused tick replays its unmarked graph outside a profiler session
    and its marked graph inside one, on the same static state: ticks traced
    in turns equal the untraced ticks bit for bit, and only the traced ones
    keep rows."""
    from torch.profiler import ProfilerActivity, profile

    from fastslam_tpu_torch.app.runner import SLAMRunner
    from fastslam_tpu_torch.drivers.replay import ReplayDriver
    from fastslam_tpu_torch.utils import profiling

    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, parity_mode=False,
                         warmup_iterations=4, proposal_mode="fastslam2",
                         use_icp_proposal=True, icp_blend=0.0, adaptive_proposal_floors=True)
    log = small_log(16)

    def drive(traced_ticks):
        runner = SLAMRunner(cfg, rng=0, device=device)
        drv, prev_cmd, outs = ReplayDriver(log), (0.0, 0.0), []
        for t in range(16):
            scan = drv.get_laser()
            pts, valid = scan.to_points()
            v, w = prev_cmd
            prev_cmd = drv.commanded_velocity()
            rot, tr = runner.odometry(v, w, scan.timestamp)
            if t in traced_ticks:
                with profile(activities=[ProfilerActivity.CPU]):
                    runner.tick_fused(pts, valid, rot, tr, v)
            else:
                runner.tick_fused(pts, valid, rot, tr, v)
            outs.append(runner._last_out.copy())
            drv.step()
        return runner, np.asarray(outs)

    profiling.TICK_TRACE.clear()
    plain, want = drive(set())
    assert profiling.TICK_TRACE.rows() == []
    traced_ticks = {0, 3, 4, 7, 8, 9, 12}
    mixed, got = drive(traced_ticks)
    rows = profiling.TICK_TRACE.rows()
    profiling.TICK_TRACE.clear()
    assert mixed._fused.replays == 15 and got.shape == want.shape == (16, 14)
    np.testing.assert_array_equal(got, want)
    for name, ref in plain.state.__dict__.items():
        if ref is not None:
            assert torch.equal(getattr(mixed.state, name), ref), name
    assert [r["key"] for r in rows] == sorted(traced_ticks)
    for r in rows:
        assert list(r["stages"]) == ["icp", "frontend", "update", "resample"]
        assert min(r["stages"].values()) > 0.0 and set(r["counters"]) == {"icp_iters",
                                                                          "resample_due"}


def segment_case(kind, device, seed=0):
    """(values [3, n], layout) on ``device``: ragged, skewed (one segment
    of ~50,000 entries), mostly empty (2^20 segments), or all entries in
    one segment with the identity order."""
    rng = np.random.default_rng(seed)
    n = 200_000
    if kind == "ragged":
        s, index = 5000, rng.integers(0, 5000, n)
    elif kind == "skewed":
        s = 300
        index = np.where(rng.random(n) < 0.25, 17, rng.integers(0, s, n))
    elif kind == "mostly_empty":
        s, index = 1 << 20, rng.integers(0, 1 << 20, n // 8)
        n = n // 8
    else:
        s, index = 1, np.zeros(n, np.int64)
    values = torch.tensor(rng.normal(0, 1, (3, n)) * rng.choice([1e-3, 1.0, 1e3], (3, n)),
                          dtype=torch.float32, device=device)
    valid = torch.tensor(rng.random(n) < 0.9, device=device)
    layout = cuda_kernels.segment_layout(torch.tensor(index, device=device), valid, s)
    return values, layout


@pytest.mark.parametrize("kind", ["ragged", "skewed", "mostly_empty", "one_segment"])
def test_segment_sum_kernel_matches_plain(device, kind):
    values, layout = segment_case(kind, device)
    before = cuda_kernels.LAUNCHES["segment_sum"]
    got = cuda_kernels.segment_sum(values, layout)
    again = cuda_kernels.segment_sum(values, layout)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["segment_sum"] == before + 2
    want = cuda_kernels.segment_sum_ref(values, layout)
    assert torch.equal(got, want) and torch.equal(again, got)
    assert torch.equal(cuda_kernels.segment_sum(values[0], layout), want[0])


def test_segment_sum_refuses_bad_inputs(device):
    values, layout = segment_case("ragged", device)
    with pytest.raises(ValueError):
        cuda_kernels.segment_sum(values.double(), layout)
    with pytest.raises(ValueError):
        cuda_kernels.segment_sum(values[:, ::2], layout)        # not contiguous


SWEEP_LENGTHS = list(range(71)) + [1000, 50_000]


def sweep_case(kind, columns, device, seed=0):
    """(values [columns, n], layout) on ``device``: ``lengths`` every
    segment length 0-70, 1,000 and 50,000 in one layout, entries
    interleaved at random, values of mixed magnitudes with signed zeros and
    a few infinities; ``signed_zeros`` the same lengths, values from
    {-0.0, +0.0, 1.5, -1.5} (sums that cancel to zero exactly) and all -0.0;
    ``identity`` the same lengths in entry order, a perm of ``arange``;
    ``hand_built`` the identity layout as perm and offsets alone (the
    wrapper lists its long segments)."""
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(SWEEP_LENGTHS)
    n = int(lengths.sum())
    if kind == "signed_zeros":
        vals = rng.choice([-0.0, 0.0, 1.5, -1.5], (columns, n))
        vals[0] = -0.0
    else:
        vals = rng.normal(0, 1, (columns, n)) * rng.choice([1e-3, 1.0, 1e3], (columns, n))
        vals = np.where(rng.random((columns, n)) < 0.02, -0.0, vals)
        vals = np.where(rng.random((columns, n)) < 0.001, np.inf, vals)
    values = torch.tensor(vals, dtype=torch.float32, device=device)
    if kind in ("identity", "hand_built"):
        offsets = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int32,
                               device=device)
        perm = torch.arange(n, dtype=torch.int32, device=device)
        layout = cuda_kernels.Segments(perm, offsets)
        if kind == "identity":
            layout = layout._replace(long=cuda_kernels.long_segments(offsets))
        return values, layout
    index = rng.permutation(np.repeat(np.arange(len(lengths)), lengths))
    return values, cuda_kernels.segment_layout(torch.tensor(index, device=device), None,
                                               len(lengths))


def backend_shape_case(call, device):
    """Shard 0 of 4's segment sums of one sparse GN iteration (chip_smoke.py
    phase 21) on a 20,000-landmark survey graph of 64 keyframes: (values,
    layout) with seeded values in the call's columns."""
    from fastslam_tpu_torch.backend import builder, distributed
    from fastslam_tpu_torch.backend.survey import survey_world_chunked
    from fastslam_tpu_torch.parallel.mesh import make_map_mesh

    noisy, obs, gt, _ = survey_world_chunked(20_000, k=64, sigma_xy=0.05, seed=1)
    g = builder.build_pose_graph(noisy, obs, association_poses=gt, association_gate=0.5,
                                 max_landmarks=1 << 15, max_factors=1 << 17, device=device)
    gs, _ = distributed.shard_pose_graph(g, 4)
    pair_a, pair_b, pair_valid = distributed.build_schur_pairs(gs, 4, device)
    layouts = distributed.schur_layouts(make_map_mesh([device] * 4), g.poses.shape[0],
                                        g.landmarks.shape[0], gs.obs_kf, gs.obs_lm,
                                        gs.obs_valid, pair_a, pair_b, pair_valid)[0]
    columns, n, layout = {
        "by_landmark": (5, gs.obs_kf.shape[0] // 4, layouts.by_lm),
        "by_keyframe": (12, gs.obs_kf.shape[0] // 4, layouts.by_kf),
        "cross": (9, pair_a.shape[0] // 4, layouts.by_cell),
        "backsub": (2, gs.obs_kf.shape[0] // 4, layouts.by_lm)}[call]
    gen = torch.Generator(device=device).manual_seed(21)
    return torch.randn((columns, n), generator=gen, device=device), layout


def assert_segment_sum_bit_for_bit(values, layout):
    """Two kernel calls, one launch each, equal to the plain version and to
    each other bit for bit (the sign of zero and NaNs included)."""
    before = cuda_kernels.LAUNCHES["segment_sum"]
    got = cuda_kernels.segment_sum(values, layout)
    assert cuda_kernels.LAUNCHES["segment_sum"] == before + 1
    again = cuda_kernels.segment_sum(values, layout)
    assert cuda_kernels.LAUNCHES["segment_sum"] == before + 2
    want = cuda_kernels.segment_sum_ref(values, layout)
    bits = lambda t: t.view(torch.int64)
    assert torch.equal(bits(got), bits(want)) and torch.equal(bits(again), bits(got))
    return want


@pytest.mark.parametrize("columns", [1, 2, 5, 9, 12, 16])
@pytest.mark.parametrize("kind", ["lengths", "signed_zeros", "identity", "hand_built"])
def test_segment_sum_kernel_sweeps_lengths(device, kind, columns):
    values, layout = sweep_case(kind, columns, device)
    want = assert_segment_sum_bit_for_bit(values, layout)
    if kind == "signed_zeros":
        assert not torch.signbit(want[0]).any()          # sums of -0.0 are +0.0


@pytest.mark.parametrize("call", ["by_landmark", "by_keyframe", "cross", "backsub"])
def test_segment_sum_kernel_on_backend_shapes(device, call):
    values, layout = backend_shape_case(call, device)
    assert_segment_sum_bit_for_bit(values, layout)


def test_backend_on_the_card_matches_cpu_and_repeats(device):
    """The sparse sharded optimizer and the dense single-device one on the
    card against the CPU (the plain segment sums), and a second card run
    bit for bit."""
    from fastslam_tpu_torch.backend import builder, distributed, pose_graph
    from fastslam_tpu_torch.parallel.mesh import make_map_mesh

    rng = np.random.default_rng(3)
    k = 24
    t = np.linspace(0, 2 * np.pi, k, endpoint=False)
    gt = np.stack([4 * np.cos(t), 4 * np.sin(t), t + np.pi / 2], axis=-1)
    lms = rng.uniform(-7, 7, (40, 2))
    obs = []
    for i in range(k):
        d = lms - gt[i, :2]
        r = np.hypot(d[:, 0], d[:, 1])
        b = (np.arctan2(d[:, 1], d[:, 0]) - gt[i, 2] + np.pi) % (2 * np.pi) - np.pi
        obs.append(np.stack([r, b], -1)[r < 6.0])
    noisy = gt + rng.normal(0, 0.3 / k, (k, 3)).cumsum(axis=0)
    noisy[0] = gt[0]
    out = {}
    for dev in ("cpu", device, device):
        g = builder.build_pose_graph(noisy, obs, max_landmarks=64, max_factors=1024,
                                     device=dev)
        sharded = distributed.optimize_sharded(g, make_map_mesh([dev] * 4), num_iters=4,
                                               damping=1e-3)
        single = pose_graph.optimize(g, num_iters=4)
        out.setdefault(str(torch.device(dev).type), []).append((sharded, single))
    (cpu_sharded, cpu_single), = out["cpu"]
    (card_sharded, card_single), (again_sharded, again_single) = out["cuda"]
    np.testing.assert_allclose(card_sharded[0].cpu().numpy(), cpu_sharded[0].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(card_sharded[1].cpu().numpy(), cpu_sharded[1].numpy(), atol=1e-3)
    np.testing.assert_allclose(card_single[0].cpu().numpy(), cpu_single[0].numpy(),
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(card_sharded[:2] + card_single[:2], again_sharded[:2] + again_single[:2]):
        assert torch.equal(a, b)
    assert card_sharded[2] == again_sharded[2]


def test_map_merge_on_the_card_matches_cpu(device):
    from fastslam_tpu_torch.backend import map_merge

    rng = np.random.default_rng(5)
    shared = rng.uniform(-40, 40, (1500, 2))
    c, s = np.cos(0.1), np.sin(0.1)
    rot = np.array([[c, -s], [s, c]])
    lm_b = ((np.concatenate([shared + rng.normal(0, 0.02, shared.shape),
                             rng.uniform(-40, 40, (300, 2))]) - [0.5, -0.3]) @ rot)
    lm_a = np.concatenate([shared, rng.uniform(-40, 40, (400, 2))])
    args = [torch.tensor(lm_a, dtype=torch.float32), torch.ones(len(lm_a), dtype=torch.bool),
            torch.tensor(lm_b, dtype=torch.float32), torch.ones(len(lm_b), dtype=torch.bool)]
    al_cpu, m_cpu, _ = map_merge.merge_sessions(*args)
    before = cuda_kernels.LAUNCHES["icp_correspondences"]
    al, m, _ = map_merge.merge_sessions(*(a.to(device) for a in args))
    assert cuda_kernels.LAUNCHES["icp_correspondences"] > before
    np.testing.assert_allclose(al.rotation.cpu().numpy(), al_cpu.rotation.numpy(), atol=1e-4)
    np.testing.assert_allclose(al.translation.cpu().numpy(), al_cpu.translation.numpy(),
                               atol=1e-4)
    assert int(al.num_matched) == int(al_cpu.num_matched)
    for field in ("valid", "matched_b", "appended_b", "dropped_b"):
        assert torch.equal(getattr(m, field).cpu(), getattr(m_cpu, field)), field



def test_check_parity_holds_the_card_to_the_cpu(device):
    """``probes.check_parity`` at the script's sizes and a small width tick
    by tick: every check within the reference's bars, each card side
    launching its kernel."""
    from fastslam_tpu_torch.probes import check_parity

    todo = [c for c in check_parity.checks(full=None)] + [("motion", 4096, "ticks"),
                                                          ("fs2", 4096, "ticks")]
    results = check_parity.run(device, todo=todo, print_lines=False)
    assert [r["ok"] for r in results] == [True] * len(todo), results
    assert all(r["launches"][r["kernel"]] >= 1 for r in results)


def test_diagnose_slip_repeats_on_the_card(device):
    """The online form twice, bit for bit, every key finite."""
    from fastslam_tpu_torch.eval import diagnose_slip

    a, b = (diagnose_slip.run_instrumented(3, particles=100, ticks=160, device=device)
            for _ in range(2))
    assert a == b
    assert all(np.all(np.isfinite(np.asarray(v, float))) for v in a.values())



@pytest.mark.parametrize("flags", [[], ["--planes"], ["--fused-only"], ["--chunk", "4"],
                                   ["--chunk", "4", "--fs2"], ["--planes", "--fs2"],
                                   ["--fs2"], ["--planes", "--with-frontend"]],
                         ids=["scan", "planes", "fusedonly", "chunked", "chunked+fs2",
                              "planes+fs2", "scan+fs2", "planes+frontend"])
def test_step_probe_graph_equals_eager(device, flags):
    """K steps in one captured graph (resample decided on the device) equal
    K eager steps bit for bit; the probe raises otherwise."""
    from fastslam_tpu_torch.probes import step

    args = step.parse(["--particles", str(P), "--landmarks", str(L), "--measurements",
                       str(M), "--k", "5"] + flags)
    rec = step.run(args)
    assert rec["graph"] and rec["draws"] == "eager_static"
    launches = dict(rec["launches_per_replay"])
    # a planes step decides its resample on the card: the staircase and the gather
    resamples = 5 if (args.planes or args.chunk) and not args.fused_only else 0
    assert launches.pop("resample_staircase", 0) == resamples
    assert launches.pop("resample_gather", 0) == resamples
    assert sum(launches.values()) == 5     # one filter kernel launch per step


def test_on_device_steps_capture(device):
    """``fastslam_step`` (fs2 with evidence weights: the EKF loop) and
    ``fastslam_steps_planes_chunked`` under ``on_device=True`` capture into a
    graph whose replay equals the host-deciding eager call bit for bit."""
    from fastslam_tpu_torch.core.state import Measurements, init_state

    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                         parity_mode=False, proposal_mode="fastslam2",
                         fs2_evidence_weights=True)
    ms = pad_measurements(cfg, [(1.5 + 0.4 * i, -2.0 + 0.6 * i) for i in range(6)], device)
    gen = torch.Generator(device=device).manual_seed(4)
    rot, trans = torch.zeros((), device=device), torch.full((), 0.4, device=device)
    state = init_state(cfg, device)
    for _ in range(3):      # a map to associate with
        state, _ = kernels.fastslam_step(state, rot, trans, ms, cfg,
                                         kernels.draw(gen, P, fs2=True))
    draws = kernels.draw(gen, P, fs2=True)
    want, want_pose = kernels.fastslam_step(state.clone(), rot, trans, ms, cfg, draws)
    static = state.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, pose = kernels.fastslam_step(static, rot, trans, ms, cfg, draws, on_device=True)
    graph.replay()
    torch.cuda.synchronize()
    for name, v in vars(want).items():
        assert torch.equal(getattr(got, name), v), name
    assert torch.equal(pose, want_pose)

    pcfg = cfg.replace(proposal_mode="motion")
    pstate, _, _ = seeded(pcfg, device, 5)
    c = 4
    zc = Measurements(ms.range_bearing[None].repeat(c, 1, 1), ms.valid[None].repeat(c, 1))
    rots, transs = torch.zeros(c, device=device), torch.full((c,), 0.4, device=device)
    draws = kernels.draw(gen, P, c)
    want, want_est = kernels.fastslam_steps_planes_chunked(pstate.clone(), rots, transs, zc,
                                                           pcfg, draws)
    static = pstate.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, est = kernels.fastslam_steps_planes_chunked(static, rots, transs, zc, pcfg, draws,
                                                         on_device=True)
    graph.replay()
    torch.cuda.synchronize()
    for name, v in vars(want).items():
        assert (v is None and getattr(got, name) is None) or torch.equal(getattr(got, name), v)
    assert torch.equal(est, want_est)


def resample_weight_cases(p, seed):
    """Weights of the staircase's edge cases at ``p`` particles (float32):
    a spread, one dominant weight, runs of zero weights, an undersum tail
    and equal weights (every cumulative sum near a grid point)."""
    rng = np.random.default_rng(seed)
    spread = rng.dirichlet(np.full(p, 0.5))
    dominant = np.full(p, 1e-12)
    dominant[rng.integers(p)] = 1.0
    zero_runs = np.zeros(p)
    picked = rng.integers(0, p, p // 8)
    zero_runs[picked] = rng.uniform(0.5, 1.0, picked.shape[0])
    cases = {"spread": spread, "dominant": dominant / dominant.sum(),
             "zero_runs": zero_runs / zero_runs.sum(), "undersum": spread * 0.97,
             "equal": np.full(p, 1.0 / p)}
    return {k: v.astype(np.float32) for k, v in cases.items()}


def resample_buffers(state, parity):
    planes = [t for t in (state.lm_mx, state.lm_my, state.lm_ca, state.lm_cb, state.lm_cc,
                          state.lm_cd) if t is not None]
    return planes, [state.poses, state.lm_count] + ([state.log_weights] if parity else [])


@pytest.mark.parametrize("parity", [False, True])
def test_resample_kernels_match_plain_at_bench_size(device, parity):
    """At P = 100,000, L = 64 the staircase kernel equals the ATen
    staircase the parent ran on the card (``grid_staircase_indices`` of
    ``fixed_order_cumsum``) and its plain version, for every weight case
    and offset; the gather equals ``resample_planes_state``."""
    p, l = 100_000, 64
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=l, parity_mode=parity)
    due = torch.tensor(True, device=device)
    before = dict(cuda_kernels.LAUNCHES)
    calls = 0
    for case, w in resample_weight_cases(p, 3).items():
        w = torch.from_numpy(w).to(device)
        for u0 in (0.0, 1e-7 / p, 0.3 / p, (p - 1) / (p * p)):
            u = torch.tensor(u0, dtype=torch.float32, device=device)
            want = kernels.grid_staircase_indices(kernels.fixed_order_cumsum(w), u, p)
            got = cuda_kernels.resample_staircase(w, u, due)
            torch.cuda.synchronize()
            calls += 1
            assert torch.equal(got, want), f"{case} u0={u0}"
            assert torch.equal(got, cuda_kernels.resample_staircase_ref(w, u, due))
    state = init_planes_state(cfg, device)
    gen = torch.Generator(device=device).manual_seed(4)
    for t in resample_buffers(state, parity)[0] + [state.poses, state.log_weights]:
        t.normal_(generator=gen)
    state.lm_count.random_(0, l + 1, generator=gen)
    idx = cuda_kernels.resample_staircase(
        torch.from_numpy(resample_weight_cases(p, 5)["spread"]).to(device),
        torch.tensor(0.4 / p, device=device), due)
    want = kernels.resample_planes_state(state.clone(), idx, cfg)
    cuda_kernels.resample_gather(*resample_buffers(state, parity), idx, due)
    torch.cuda.synchronize()
    for k, v in vars(state).items():
        if v is not None and (k != "log_weights" or parity):
            assert torch.equal(v, getattr(want, k)), k
    assert cuda_kernels.LAUNCHES["resample_staircase"] == before["resample_staircase"] + calls + 1
    assert cuda_kernels.LAUNCHES["resample_gather"] == before["resample_gather"] + 1


def test_resample_not_due_touches_no_buffer(device):
    """With no resample due the gather leaves every buffer where and as it
    was, whatever the ancestors hold."""
    p, l = 100_000, 64
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=l, parity_mode=True)
    state = init_planes_state(cfg, device)
    gen = torch.Generator(device=device).manual_seed(6)
    planes, rows = resample_buffers(state, True)
    for t in planes + [state.poses, state.log_weights]:
        t.normal_(generator=gen)
    state.lm_count.random_(0, l + 1, generator=gen)
    copies = [t.clone() for t in planes + rows]
    pointers = [t.data_ptr() for t in planes + rows]
    due = torch.tensor(False, device=device)
    idx = cuda_kernels.resample_staircase(torch.full((p,), 1.0 / p, device=device),
                                          torch.zeros((), device=device), due)
    idx.fill_(p - 1)                # ancestors it must not read
    cuda_kernels.resample_gather(planes, rows, idx, due)
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in planes + rows] == pointers
    for t, c in zip(planes + rows, copies):
        assert torch.equal(t, c)


def test_resample_graph_equals_eager_over_due_and_quiet_ticks(device):
    """``_normalize_and_resample(on_device=True)`` captured in a CUDA graph
    over static buffers, replayed over ticks of which some resample and some
    do not, equals the same ticks run eagerly bit for bit; the graph's state
    is the caller's own planes, counts and poses."""
    p, l = 100_000, 64
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=l, parity_mode=False)
    gen = torch.Generator(device=device).manual_seed(8)
    start = init_planes_state(cfg, device)
    for t in resample_buffers(start, False)[0] + [start.poses]:
        t.normal_(generator=gen)
    start.lm_count.random_(0, l + 1, generator=gen)
    spreads = [4.0, 0.0, 0.0, 3.0, 0.0, 5.0]     # wide spreads resample
    ticks = [(torch.randn(p, device=device, generator=gen) * s,
              torch.rand((), device=device, generator=gen) / p) for s in spreads]
    static, static_u0 = start.clone(), torch.zeros((), device=device)

    def body():
        new = kernels._normalize_and_resample(static, static_u0, cfg, on_device=True)
        for name, dst in vars(static).items():
            if dst is not None:
                dst.copy_(getattr(new, name))
        return new

    # builds the kernels and warms the allocator on a copy, off the capture
    kernels._normalize_and_resample(start.clone(), static_u0, cfg, on_device=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new = body()
    assert all(getattr(new, k) is getattr(static, k)
               for k in ("lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cd", "lm_count"))
    eager, due_ticks = start.clone(), 0
    for lw, u0 in ticks:
        neff = kernels.effective_particles(kernels.normalize_log_weights(lw, cfg), cfg)
        due_ticks += bool(neff < cfg.resample_threshold_frac * p)
        eager = kernels._normalize_and_resample(eager.replace(log_weights=lw.clone()),
                                                u0.clone(), cfg, on_device=True)
        static.log_weights.copy_(lw)
        static_u0.copy_(u0)
        graph.replay()
        torch.cuda.synchronize()
        for k, v in vars(eager).items():
            assert (v is None) == (getattr(static, k) is None), k
            assert v is None or torch.equal(v, getattr(static, k)), k
    assert 0 < due_ticks < len(ticks)
    # the device form against the host-decided one from the same start
    host = start.clone()
    for lw, u0 in ticks:
        host = kernels._normalize_and_resample(host.replace(log_weights=lw.clone()), u0, cfg)
    for k, v in vars(host).items():
        assert v is None or torch.equal(v, getattr(static, k)), k


if __name__ == "__main__":
    import os
    import sys

    if sys.argv[1] == "bad-handle":
        bad_handle_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1] == "silent":
        silent_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], float(sys.argv[5]))
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


@pytest.mark.parametrize("proposal,row", [("motion", "fused_update_planes_multi"),
                                          ("fastslam2", "fused_fs2_planes_multi")])
def test_bench_chunked_graph(device, proposal, row):
    """The benchmark's chunked window at reduced reps: its graph held to the
    eager chunks bit for bit (``time_window`` raises otherwise), a finite
    rate, one launch per chunk in the reference, the check's replay and
    each timed replay."""
    from fastslam_tpu_torch import bench

    before = cuda_kernels.LAUNCHES[row]
    ups, step_s = bench.bench_chunked(5 * C + 1, C, proposal, reps=3, budget_s=10.0,
                                      num_particles=P, num_landmarks=L,
                                      num_measurements=M, device=device)
    assert np.isfinite(ups) and ups > 0
    assert ups == pytest.approx(P * M / step_s)
    assert cuda_kernels.LAUNCHES[row] - before == 5 * (2 + 3)


# ------------------------------------------------------- the checkpoint encoder

def deflate_case(kind, device):
    """``(tensor, row_bytes)`` of a crafted member on the card."""
    g = torch.Generator().manual_seed(len(kind))
    if kind == "zeros":
        return torch.zeros(300, 64, 4, device=device), 1024
    if kind == "row_repeats":
        a = torch.zeros(301, 64, 2)
        a[:, :9] = torch.randn(301, 9, 2, generator=g)
        a[1::2] = a[0:300:2]
        return a.to(device), 512
    if kind == "high_bytes":
        return torch.randint(144, 256, (300, 512), generator=g, dtype=torch.uint8).to(device), 512
    if kind == "row_12":
        a = torch.randn(1001, 3, generator=g)
        a[5::4] = a[4:1000:4][:len(a[5::4])]
        return a.to(device), 12
    if kind == "row_4":
        return torch.randint(0, 3, (5001,), generator=g, dtype=torch.int32).to(device), 4
    if kind == "planes":
        a = torch.zeros(16, 3001)
        a[:5, ::7] = torch.randn(5, 429, generator=g)
        return a.to(device), 0
    assert kind == "long_runs"
    return torch.full((5000,), 0x41414141, dtype=torch.int32, device=device), 0


@pytest.mark.parametrize("kind", ["zeros", "row_repeats", "high_bytes", "row_12", "row_4",
                                  "planes", "long_runs"])
def test_deflate_kernel_matches_plain(device, kind):
    import zlib

    data, row = deflate_case(kind, device)
    before = cuda_kernels.LAUNCHES["deflate_fixed"]
    stream, info = cuda_kernels.deflate_fixed(data, row, 0x9E3779B9)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["deflate_fixed"] == before + 1
    want, want_info = cuda_kernels.deflate_fixed_ref(data.cpu(), row, 0x9E3779B9)
    assert torch.equal(stream.cpu(), want) and torch.equal(info.cpu(), want_info)
    raw = data.cpu().numpy().tobytes()
    n = (int(info[0]) + 7) // 8
    assert zlib.decompress(stream[:n].cpu().numpy().tobytes(), wbits=-15) == raw
    assert int(info[1]) == zlib.crc32(raw, 0x9E3779B9)


def test_deflate_refuses_what_it_cannot_take(device):
    before = cuda_kernels.LAUNCHES["deflate_fixed"]
    base = torch.zeros(4096, dtype=torch.uint8, device=device)
    for bad in (torch.zeros(64, 64, device=device).t(), base[:6], base[1:65]):
        with pytest.raises(ValueError):
            cuda_kernels.deflate_fixed(bad, 0)
    assert cuda_kernels.LAUNCHES["deflate_fixed"] == before


def test_deflate_kernel_matches_plain_on_a_driven_state(device, tmp_path):
    """At P = 100,000, L = 64: the hooked loop's checkpoint after 400 ticks
    of fs2 + ICP with wheel slip launches the encoder once per large member;
    on that state each member's stream equals the plain version's, and the
    checkpoint written from the card reads back as the one written from its
    CPU copy (zlib, nothing encoded on the card) array for array."""
    from fastslam_tpu_torch.io import checkpoint
    from fastslam_tpu_torch.probes import checkpoint_deflate

    state, launches = checkpoint_deflate.driven_checkpoint(str(tmp_path / "driven.npz"),
                                                           ticks=400, device=device)
    members = checkpoint.encoder_members(state)
    assert [m[0] for m in members] == ["poses", "log_weights", "lm_count", "lm_mean", "lm_cov"]
    assert launches == len(members)
    for name, t, row in members:
        assert checkpoint_deflate.same_encoding(t, row), name
    on_card = checkpoint.save_checkpoint(str(tmp_path / "card.npz"), state, iteration=400)
    host = state.replace(**{k: v.cpu() for k, v in state.__dict__.items()})
    on_cpu = checkpoint.save_checkpoint(str(tmp_path / "cpu.npz"), host, iteration=400)
    assert on_card.device_bytes == sum(t.nbytes for _, t, _ in members) > 150e6
    assert on_card.row_match_bytes > 0 and on_cpu == (0, 0)
    with np.load(tmp_path / "card.npz") as a, np.load(tmp_path / "cpu.npz") as b:
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)


def test_hooks_count_what_the_card_encoded(device, tmp_path):
    """The production hooks' counters on the card: every large member of
    the blocks state deflated there, and a fresh state's maps (zeros) all
    but their first row matches one particle back."""
    from fastslam_tpu_torch.app.runner import ProductionHooks, SLAMRunner
    from fastslam_tpu_torch.eval.metrics import evaluate_tick
    from fastslam_tpu_torch.io import checkpoint

    cfg = FastSLAMConfig(num_particles=300, max_landmarks=64, parity_mode=False)
    hooks = ProductionHooks(cfg, checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=2)
    runner = SLAMRunner(cfg, rng=0, device=device)
    est = gt = np.zeros(3)
    before = cuda_kernels.LAUNCHES["deflate_fixed"]
    for t in range(3):
        hooks.after_tick(runner, t, est, gt, evaluate_tick(gt, est))
    large = checkpoint.encoder_members(runner.state_blocks())
    assert cuda_kernels.LAUNCHES["deflate_fixed"] - before == len(large) > 0
    assert hooks.checkpoint_device_bytes == sum(t.nbytes for _, t, _ in large)
    assert hooks.checkpoint_match_pct > 90.0
