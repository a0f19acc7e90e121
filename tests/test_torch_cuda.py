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
    monkeypatch.setattr(cuda_kernels, "FS2_TILE", geometry[0])
    monkeypatch.setattr(cuda_kernels, "FS2_LANES", geometry[1])
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
    monkeypatch.setattr(cuda_kernels, "MOTION_TILE", geometry[0])
    monkeypatch.setattr(cuda_kernels, "MOTION_LANES", geometry[1])
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
    monkeypatch.setattr(cuda_kernels, "MOTION_TILE", geometry[0])
    monkeypatch.setattr(cuda_kernels, "MOTION_LANES", geometry[1])
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
    monkeypatch.setattr(cuda_kernels, "ICP_THREADS", geometry[0])
    monkeypatch.setattr(cuda_kernels, "ICP_LANES", geometry[1])
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
    assert results["resample"] == {"ring_launches": 1, "halo_path": 1}
    single = dryrun.run_steps(cfg, None, device, ms, chunk=C, ticks=3)
    for mode, (layout, _, kernel) in dryrun.MODES.items():
        r = results[mode]
        # dryrun_multichip checked the launches: S per tick or chunk
        assert r["launches"] == {kernel: 4 * (3 if layout in ("blocks", "planes") else 1)}
        assert torch.equal(r["est"], single[mode]["est"]), mode
        for k, v in single[mode]["state"].__dict__.items():
            g = getattr(r["state"], k)
            assert (v is None and g is None) or torch.equal(g, v), (mode, k)


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
