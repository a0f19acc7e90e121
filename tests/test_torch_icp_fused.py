"""The fused point-to-line ICP's plain version and its fixed-order sums, on
the CPU.

``core/kernels.py:tree_sum`` adds in the one order the fused kernel
(``csrc/icp_nn.cu``) adds in: zeros pad the axis to a power of two, then
``x[i] += x[i + h]`` for h = half, ..., 1.  It is held to that halving bit
for bit, and to a float64 sum within 1e-6 relative (positive terms: a
pairwise sum of 2^k terms is off by at most k half-ulps of the total).

``cuda_kernels.icp_point_to_line_ref`` (the kernel's plain version, which
the proposal's ``icp_point_to_line`` runs on the CPU) is held to the JAX
package's ``icp_point_to_line`` on the warm-started pairs of the 48-tick
seed-3 drive, as ``tests/test_torch_icp.py`` holds the proposal: theta and
translation within atol 1e-5, the mean error within rtol 1e-5 plus atol
2.4e-7 (the float32 spacing of the points' coordinates), iteration counts
equal.  The sums' order differs from ``jnp.sum``'s, which moves the mean
error by ulps, so the tolerances are those of ``test_torch_icp.py``.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.proposal import icp as jax_icp

from fastslam_tpu_torch.app.runner import odometry, scan_points
from fastslam_tpu_torch.core import _build, cuda_kernels
from fastslam_tpu_torch.core.kernels import tree_sum
from fastslam_tpu_torch.drivers.replay import record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.interop import config_from_jax_fields
from fastslam_tpu_torch.proposal import icp

torch.set_num_threads(1)

JCFG = JaxConfig()
CFG = config_from_jax_fields(dataclasses.asdict(JCFG))
MAX_ITER, TOL = CFG.icp_max_iterations, CFG.icp_tolerance


def halving(x: np.ndarray) -> np.ndarray:
    """The tree written out in numpy float32: pad with zeros to a power of
    two, then add the upper half onto the lower half until one is left."""
    n = x.shape[-1]
    p2 = 1
    while p2 < n:
        p2 *= 2
    y = np.zeros(x.shape[:-1] + (p2,), np.float32)
    y[..., :n] = x
    h = p2 // 2
    while h >= 1:
        y[..., :h] = y[..., :h] + y[..., h:2 * h]
        h //= 2
    return y[..., 0]


def terms(n, seed):
    """Positive float32 terms over six decades, [3, n]."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.0, (3, n)) * 10.0 ** rng.uniform(-3, 3, (3, n))
            ).astype(np.float32)


@pytest.mark.parametrize("n", [1, 7, 180, 256, 1000])
def test_tree_sum_is_the_pairwise_halving(n):
    x = terms(n, n)
    got = tree_sum(torch.from_numpy(x)).numpy()
    assert got.shape == (3,)
    assert got.tobytes() == halving(x).tobytes()


@pytest.mark.parametrize("n", [1, 7, 180, 256, 1000])
def test_tree_sum_is_close_to_the_float64_sum(n):
    x = terms(n, 100 + n)
    got = tree_sum(torch.from_numpy(x)).numpy().astype(np.float64)
    want = x.astype(np.float64).sum(axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


@pytest.fixture(scope="module")
def pairs():
    """Warm-started (source, target, source_valid, target_valid) of the 47
    consecutive pairs of the drive, float32 numpy (``test_torch_icp.py``)."""
    log = record_log(SimWorld(seed=3), num_ticks=48)
    pts, valid = scan_points(log)
    rots, trans = odometry(log, CFG)
    c, s = np.cos(-rots[1:]), np.sin(-rots[1:])
    src = pts[:-1]
    pre = np.stack([c[:, None] * src[..., 0] - s[:, None] * src[..., 1],
                    s[:, None] * src[..., 0] + c[:, None] * src[..., 1]], -1)
    pre[..., 0] -= trans[1:, None]
    return pre.astype(np.float32), pts[1:], valid[:-1], valid[1:]


def ref(pairs, max_iter=MAX_ITER, tol=TOL):
    src, tgt, sv, tv = (torch.from_numpy(np.ascontiguousarray(a)) for a in pairs)
    normals, n_ok = icp.estimate_normals(tgt, tv)
    return cuda_kernels.icp_point_to_line_ref(src, tgt, sv, tv, normals, n_ok, max_iter, tol)


def jax_ref(pairs, max_iter=MAX_ITER, tol=TOL):
    jcfg = JCFG.replace(icp_max_iterations=max_iter, icp_tolerance=tol)
    res = jax.jit(jax.vmap(lambda s, t, sv, tv: jax_icp.icp_point_to_line(s, t, sv, tv, jcfg)))(
        *(jnp.asarray(a) for a in pairs))
    return tuple(np.asarray(a) for a in (res.theta, res.translation, res.mean_error,
                                         res.num_iters))


def assert_matches_jax(got, want):
    theta, trans, err, iters = (t.numpy() for t in got)
    np.testing.assert_array_equal(iters, want[3])
    np.testing.assert_allclose(theta, want[0], atol=1e-5)
    np.testing.assert_allclose(trans, want[1], atol=1e-5)
    np.testing.assert_allclose(err, want[2], rtol=1e-5, atol=2.4e-7)


def test_plain_version_matches_jax(pairs):
    got = ref(pairs)
    assert [tuple(t.shape) for t in got] == [(47,), (47, 2), (47,), (47,)]
    assert got[3].dtype == torch.int32
    assert_matches_jax(got, jax_ref(pairs))
    # the drive moves: every pair converged, after different counts
    iters = got[3].numpy()
    assert iters.max() < MAX_ITER and iters.min() >= 2 and len(set(iters.tolist())) > 1


def test_the_proposal_runs_the_plain_version(pairs):
    """``proposal/icp.icp_point_to_line`` on CPU tensors is the plain
    version, bit for bit, with the rotation matrix of its theta."""
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in pairs)
    got = icp.icp_point_to_line(*args, CFG)
    want = ref(pairs)
    for name, w in zip(("theta", "translation", "mean_error", "num_iters"), want):
        assert torch.equal(getattr(got, name), w), name
    assert torch.equal(got.rotation, icp.rotation_matrix(want[0]))


def test_plain_version_keeps_converged_pairs_frozen(pairs):
    """Each pair of a batch ends where it ends alone."""
    batch = ref(pairs)
    iters = batch[3].numpy()
    for k in (int(np.argmin(iters)), int(np.argmax(iters))):
        alone = ref(tuple(a[k:k + 1] for a in pairs))
        for b, a in zip(batch, alone):
            assert torch.equal(a[0], b[k])


@pytest.mark.parametrize("max_iter", [0, 1, 3])
def test_plain_version_stops_at_max_iterations(pairs, max_iter):
    got = ref(pairs, max_iter=max_iter, tol=0.0)
    assert (got[3].numpy() == max_iter).all()
    assert_matches_jax(got, jax_ref(pairs, max_iter=max_iter, tol=0.0))
    if max_iter == 0:
        assert (got[0] == 0).all() and (got[1] == 0).all() and torch.isinf(got[2]).all()


def test_an_invalid_cloud_runs_to_max_iterations(pairs):
    """A pair whose target has no valid point (every distance inf, every
    weight 0: a NaN mean error) never converges and runs all iterations; one
    whose source has none reads a mean error of 0 twice and stops after 2;
    both as in JAX, and their neighbour in the batch is not touched."""
    some = tuple(np.array(a[:3]) for a in pairs)
    some[3][0] = False
    some[2][1] = False
    got = ref(some, max_iter=5)
    want = jax_ref(some, max_iter=5)
    assert got[3].tolist()[:2] == [5, 2]
    assert torch.isnan(got[2][0]) and np.isnan(want[2][0])
    assert_matches_jax(got, want)
    alone = ref(tuple(a[2:] for a in some), max_iter=5)
    for b, a in zip(got, alone):
        assert torch.equal(a[0], b[2])


B, N, MT = 2, 6, 5
f32 = lambda *s: torch.zeros(s, dtype=torch.float32)
flag = lambda *s: torch.ones(s, dtype=torch.bool)
GOOD = dict(source=f32(B, N, 2), target=f32(B, MT, 2), source_valid=flag(B, N),
            target_valid=flag(B, MT), normals=f32(B, MT, 2), normal_valid=flag(B, MT))


@pytest.mark.parametrize("name,bad,match", [
    ("source", f32(N, 2), "source must be"),
    ("source", f32(B, 0, 2), "source must be"),
    ("source", torch.zeros((B, N, 2), dtype=torch.float64), "source must be float32"),
    ("target", f32(B + 1, MT, 2), "target must be"),
    ("target", f32(B, 0, 2), "target must be"),
    ("normals", f32(B, MT, 3), "normals must be"),
    ("normals", torch.zeros((B, MT, 2), dtype=torch.int32), "normals must be"),
    ("source_valid", f32(B, N), "source_valid must be"),
    ("target_valid", flag(B, MT + 1), "target_valid must be"),
    ("normal_valid", torch.ones((B, MT), dtype=torch.uint8), "normal_valid must be"),
    ("normal_valid", torch.ones((B, MT), dtype=torch.bool, device="meta"),
     "normal_valid must be"),
])
def test_fused_wrapper_refuses_bad_inputs(name, bad, match):
    args = dict(GOOD, **{name: bad})
    with pytest.raises(ValueError, match=match):
        cuda_kernels.icp_point_to_line_fused(*args.values(), MAX_ITER, TOL)


def test_fused_wrapper_refuses_negative_max_iter():
    with pytest.raises(ValueError, match="max_iter must be >= 0"):
        cuda_kernels.icp_point_to_line_fused(*GOOD.values(), -1, TOL)


def launched_args(monkeypatch, n, mt):
    """The arguments the fused wrapper hands its launcher for a CUDA call
    (the launch faked, the tensors on the meta device)."""
    class FakeLibrary:
        def __getattr__(self, fn):
            return fn

    calls = []
    monkeypatch.setattr(cuda_kernels, "_require_cuda", lambda *t: torch.device("meta"))
    monkeypatch.setattr(cuda_kernels, "_ptr", lambda t: t)     # the tensors themselves
    monkeypatch.setattr(cuda_kernels, "_launch",
                        lambda fn, device, *args: calls.append((fn, args)))
    monkeypatch.setattr(_build, "load", lambda: FakeLibrary())
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
    before = cuda_kernels.LAUNCHES["icp_point_to_line"]
    out = cuda_kernels.icp_point_to_line_fused(
        meta(3, n, 2), meta(3, mt, 2), meta(3, n, dtype=torch.bool),
        meta(3, mt, dtype=torch.bool), meta(3, mt, 2), meta(3, mt, dtype=torch.bool), 7, 1e-5)
    assert cuda_kernels.LAUNCHES["icp_point_to_line"] == before + 1
    cuda_kernels.LAUNCHES["icp_point_to_line"] = before
    (fn, args), = calls
    assert fn == "icp_point_to_line_launch"
    assert [tuple(t.shape) for t in out] == [(3,), (3, 2), (3,), (3,)]
    return [getattr(a, "value", a) for a in args]


@pytest.mark.parametrize("n,mt,p2,scratch", [(180, 180, 256, False), (1, 1, 1, False),
                                             (1000, 2500, 1024, False),
                                             (4096, 8192, 4096, True)])
def test_fused_wrapper_launches_one_block_per_pair(monkeypatch, n, mt, p2, scratch):
    """One launch with the sums padded to the least power of two >= N, the
    per-point arrays in device-memory scratch only past what shared memory
    holds, and the timed threads and lanes per pair."""
    args = launched_args(monkeypatch, n, mt)
    if scratch:
        assert tuple(args[6].shape) == (3, 11 * p2 + 2 * n)
    else:
        assert args[6] is None
    assert args[11:] == [3, n, mt, p2, 7, pytest.approx(1e-5),
                         cuda_kernels.ICP_THREADS, cuda_kernels.ICP_LANES]
    assert cuda_kernels.icp_fused_layout(n, mt)[0] == p2


def test_fused_layout_is_the_kernels():
    """``icp_fused_layout`` and ``csrc/icp_nn.cu`` use the same tile, sums
    and shared-memory threshold."""
    text = (_build.CSRC / "icp_nn.cu").read_text()
    constant = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert constant("TGT_TILE") == cuda_kernels.ICP_TGT_TILE
    assert constant("kSums") == cuda_kernels.ICP_SUMS
    assert constant("kPointSmemBytes") == cuda_kernels.ICP_POINT_SMEM_BYTES
    assert constant("kSmemOptInLimit") == cuda_kernels.SMEM_OPT_IN_BYTES
    assert "tile * 5 * 4 + (in_scratch ? 0 : points)" in text      # 20 bytes a target
    assert cuda_kernels.icp_fused_layout(180, 180) == (256, 20 * 180 + 4 * (11 * 256 + 360),
                                                       False)
    assert cuda_kernels.icp_fused_layout(4096, 8192) == (4096, 20 * 1024, True)


def test_rotation_check_plain_version_is_torch_trig():
    x = torch.linspace(-4 * np.pi, 4 * np.pi, 1001)
    s, c = cuda_kernels.icp_rotation_sin_cos(x)
    assert torch.equal(s, torch.sin(x)) and torch.equal(c, torch.cos(x))
    with pytest.raises(ValueError, match="float32 vector"):
        cuda_kernels.icp_rotation_sin_cos(x.double())
