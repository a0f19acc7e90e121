"""The chunked motion kernel's tile, staged once per chunk, checked without a GPU.

``csrc/fused_update.cu:fused_update_planes_multi_kernel`` stages a tile of
particles' planes in shared memory once per chunk (``csrc/tile.cuh``), runs
the C ticks against shared memory only and writes back once, in production
and in parity mode.  Here, on the CPU:

* the plain chunked version (what the kernel is held to on the card) equals
  the JAX Pallas kernel in interpret mode in both modes, C in {1, 4}, with
  maps that fill to L within the chunk: floats at the 1e-5 / 1e-4 bars of
  ``tests/test_pallas.py``, counts exact;
* a numpy model of the kernel's bookkeeping (stage only the slots below
  each tile's largest start count, run the C ticks on the tile, write back
  only the stored slots below the tile's grown ``rows``) equals the plain
  version bit for bit, on tiles of mixed counts, a ragged last tile, slots
  appended on one tick and read again on a later one, and tiles whose
  ``rows`` grows past the staged rows;
* the wrapper launches with ``motion_launch_geometry``'s tile and lanes in
  both modes, and computes no cos/sin of the motion increments;
* the launcher takes the per-tick kernel's byte count and limits, and the
  kernel stages and writes back once per launch.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.core.pallas_kernels import (
    fused_update_planes_multi as jax_fused_update_planes_multi,
)

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import _build, cuda_kernels
from fastslam_tpu_torch.core.cuda_kernels import motion_launch_geometry
from fastslam_tpu_torch.core.cuda_kernels._launch import ptr
from fastslam_tpu_torch.core.cuda_kernels.filter import (
    _measurement_loop, _measurement_table, _propagate_rows, _start,
)
from fastslam_tpu_torch.interop import config_from_jax_fields

from test_torch_build import fake_library
from test_torch_fused_multi import chunk_inputs
from test_torch_fused_update import PLANES, base_config, seeded_planes

torch.set_num_threads(1)

# a NaN with a payload: what an unstaged slot of the model's tile holds, so a
# read of one would poison the outputs
UNSTAGED = np.array([0x7FC0BEEF], np.uint32).view(np.float32)[0]


def torch_state(st):
    return {k: None if v is None else torch.from_numpy(v.copy()) for k, v in st.items()}


def plain_chunk(st, z, z_valid, noisy_rot, noisy_trans, cfg):
    t = torch_state(st)
    return cuda_kernels.fused_update_planes_multi(
        t["poses"], t["log_weights"], *(t[k] for k in PLANES), t["lm_count"],
        torch.from_numpy(z), torch.from_numpy(z_valid), torch.from_numpy(noisy_rot),
        torch.from_numpy(noisy_trans), cfg)


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("c", [1, 4])
def test_plain_chunk_matches_jax_on_maps_filling_to_l(parity, c):
    """Eight measurements a tick, most of them new: maps with a few free
    slots fill to L=8 within the chunk and then refuse appends.  In parity
    the chunk moves a tenth as far, so the poses stay near the origin as
    ``seeded_planes`` requires of that mode (its robot-frame association
    turns metre-scale moves into innovations that carry the interpret
    mode's last-bit differences past 1e-5)."""
    p, l, m = 256, 8, 8
    jcfg = base_config(parity, p, l, m)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    st = seeded_planes(p, l, seed=21 + c, fill=6, parity=parity)
    z, z_valid, noisy_rot, noisy_trans = chunk_inputs(c, m, p, seed=22 + c)
    if parity:
        noisy_rot, noisy_trans = noisy_rot * np.float32(0.1), noisy_trans * np.float32(0.1)
    z_valid[:] = True
    z_valid[0, 1] = False                                # an interior hole
    want = jax_fused_update_planes_multi(
        *(jnp.asarray(st[k]) if st[k] is not None else None
          for k in ("poses", "log_weights", *PLANES, "lm_count")),
        jnp.asarray(z), jnp.asarray(z_valid), jnp.asarray(noisy_rot),
        jnp.asarray(noisy_trans), jcfg, interpret=True)
    got = plain_chunk(st, z, z_valid, noisy_rot, noisy_trans, cfg)
    for name, w, g in zip(("tx", "ty", "tyaw", "tlogw"), want[:4], got[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:c], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    for name, w, g in zip(PLANES, want[4:10], got[4:10]):
        if name == "lm_cc" and not parity:
            assert w is None and g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(got[10].numpy(), np.asarray(want[10]).reshape(-1))
    before, after = st["lm_count"], got[10].numpy()
    assert ((before < l) & (after == l)).any()          # filled to L in the chunk
    assert (after <= l).all()
    assert (got[3][-1].numpy() != st["log_weights"]).any()


def landmark_chunk(p, l, c, parity, seed):
    """A planes state of mixed counts and the chunk's measurements of six
    fixed world landmarks from the nominal pose of each tick (translate 0.4
    m, every third tick rotate 0.3 rad): a landmark appended on one tick is
    matched on the next."""
    rng = np.random.default_rng(seed)
    st = seeded_planes(p, l, seed=seed, fill=l, parity=parity)
    st["lm_mx"] += np.float32(9.0)           # the seeded map lies away from the drive
    counts = rng.integers(0, l + 1, p).astype(np.int32)
    counts[::7] = l - 1
    counts[::11] = 0
    counts[:32] = rng.integers(0, 4, 32)     # a first tile of few landmarks: rows grows
    st["lm_count"] = counts
    world = np.array([[2.0, 1.0], [3.0, -1.5], [4.5, 0.5], [1.5, -2.5], [5.0, 2.0],
                      [3.5, 3.0]])
    m = len(world)
    rotating = np.arange(c) % 3 == 2
    noisy_rot = np.where(rotating[:, None], rng.normal(0.3, 0.005, (c, p)),
                         0.0).astype(np.float32)
    noisy_trans = np.where(rotating[:, None], 0.0,
                           rng.normal(0.4, 0.005, (c, p))).astype(np.float32)
    z = np.zeros((c, m, 2), np.float32)
    x = y = yaw = 0.0
    for k in range(c):
        yaw += 0.3 if rotating[k] else 0.0
        x += 0.0 if rotating[k] else 0.4 * np.cos(yaw)
        y += 0.0 if rotating[k] else 0.4 * np.sin(yaw)
        dx, dy = world[:, 0] - x, world[:, 1] - y
        z[k, :, 0] = np.hypot(dx, dy)
        z[k, :, 1] = np.arctan2(dy, dx) - yaw
    z_valid = np.ones((c, m), bool)
    z_valid[0, 2] = False                    # an interior hole
    return st, z, z_valid, noisy_rot, noisy_trans


def bits(t):
    return t.contiguous().view(torch.int32).numpy()


def staged_chunk_model(st, z, z_valid, noisy_rot, noisy_trans, cfg, tile):
    """The chunked kernel's bookkeeping, with the plain version's arithmetic.

    Each tile of ``tile`` particles stages the slots below its largest
    start count (``rows``); the rest of the tile holds UNSTAGED.  The C
    ticks run on the tiles only.  A slot counts as stored when a tick
    changes its bits in any plane or its det entry (a store of the same
    bits is invisible to the write-back).  ``rows`` grows to the tile's
    largest final count, and only stored slots below it go back.

    Returns the outputs as the plain version gives them and, per tick, the
    slots each tick stored, with ``rows`` before and after the chunk."""
    parity = cfg.parity_mode
    names = [k for k in PLANES if parity or k != "lm_cc"]
    l, p = st["lm_mx"].shape
    slot = np.arange(l)[:, None]
    tile_of = np.arange(p) // tile
    count0 = st["lm_count"]
    rows0 = np.array([count0[i:i + tile].max() for i in range(0, p, tile)])
    staged = slot < rows0[tile_of]
    t = torch_state(st)
    for k in names:
        t[k] = torch.from_numpy(np.where(staged, st[k], UNSTAGED).astype(np.float32))

    planes = tuple(t[k] if k in names else None for k in PLANES)
    z4, zvalid, mlast = _measurement_table(torch.from_numpy(z), torch.from_numpy(z_valid))
    rot, trans = torch.from_numpy(noisy_rot), torch.from_numpy(noisy_trans)
    slot_t, pose_rows, carry = _start(t["poses"], t["log_weights"], planes, t["lm_count"],
                                      cfg)
    cnr, snr = torch.cos(rot), torch.sin(rot)
    c = rot.shape[0]
    traj = torch.empty((4, c, p))
    stored = []
    for k, mtrip in enumerate(mlast.tolist()):
        pose_rows = _propagate_rows(*pose_rows, rot[k], trans[k], cnr[k], snr[k])
        before = [bits(x) for x in carry[:7]]
        carry = _measurement_loop(carry, pose_rows, z4[k], zvalid[k], mtrip, slot_t, cfg)
        stored.append(np.any([bits(x) != b for x, b in zip(carry[:7], before)], axis=0))
        traj[:3, k] = torch.cat(pose_rows[:3])
        traj[3, k] = carry[8][0]
    count = carry[7].reshape(-1).numpy()
    rows = np.maximum(rows0, [count[i:i + tile].max() for i in range(0, p, tile)])
    written = np.any(stored, axis=0)
    below = slot < rows[tile_of]
    assert not (written & ~below).any(), "a stored slot lies above the tile's rows"
    tile_planes = dict(zip(PLANES, (carry[0], carry[1], carry[2], carry[3],
                                    carry[4] if parity else None, carry[5])))
    out = {k: np.where(written & below, tile_planes[k].numpy(), st[k]) if k in names
           else None for k in PLANES}
    outputs = (*traj.numpy(), *(out[k] for k in PLANES), count)
    return outputs, stored, rows0, rows


def assert_bits_equal(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, i
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=str(i))


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("p,l,c", [(100, 8, 4), (77, 12, 6)])
def test_staged_chunk_bookkeeping_equals_the_plain_version(parity, p, l, c):
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=l, max_measurements=6,
                         parity_mode=parity, default_landmark_cov=0.125)
    tile = motion_launch_geometry(l, 6, parity)[0]
    st, z, z_valid, noisy_rot, noisy_trans = landmark_chunk(p, l, c, parity, seed=p + l)
    got, stored, rows0, rows = staged_chunk_model(st, z, z_valid, noisy_rot, noisy_trans,
                                                  cfg, tile)
    want = plain_chunk(st, z, z_valid, noisy_rot, noisy_trans, cfg)
    assert_bits_equal(want, got)

    count0 = st["lm_count"]
    tiles = [count0[i:i + tile] for i in range(0, p, tile)]
    assert p % tile and any(x.min() < x.max() for x in tiles)   # ragged, mixed counts
    # slots appended on one tick (at or above the particle's start count) and
    # stored again on a later tick: read from the tile, never from the planes
    appended = np.arange(l)[:, None] >= count0[None, :]
    ticks_stored = np.sum(stored, axis=0)
    assert (appended & (ticks_stored >= 2)).any()
    # rows grew past the staged rows; a write-back that stopped at the staged
    # rows would lose the appends there
    grew = rows > rows0
    assert grew.any()
    tile_of = np.arange(p) // tile
    lost = np.arange(l)[:, None] >= rows0[tile_of]
    assert any((w.numpy() != s)[lost].any() for w, s in zip(want[4:6], (st["lm_mx"],
                                                                         st["lm_my"])))


@pytest.mark.parametrize("parity,l", [(False, 16), (False, 64), (False, 256), (True, 16),
                                      (True, 64), (True, 256), (True, 512)])
def test_the_wrapper_launches_with_the_geometry(monkeypatch, parity, l):
    """Production up to the packed key's 256 slots, parity up to 512 (a
    tile below 32)."""
    calls, trig = fake_library(monkeypatch), []
    for name in ("cos", "sin"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda x, real=real: trig.append(tuple(x.shape))
                            or real(x))
    p, m, c = 100, 16, 5
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=l, max_measurements=m,
                         parity_mode=parity)
    launches = cuda_kernels.LAUNCHES["fused_update_planes_multi"]
    cuda_kernels.fused_update_planes_multi(
        meta(p, 3), meta(p), *(meta(l, p) for _ in range(4)),
        meta(l, p) if parity else None, meta(l, p), meta(p, dtype=torch.int32),
        meta(c, m, 2), meta(c, m, dtype=torch.bool), meta(c, p), meta(c, p), cfg)
    cuda_kernels.LAUNCHES["fused_update_planes_multi"] = launches
    (fn, (_, *args, _)), = calls
    assert fn == "fused_update_planes_multi_launch"
    assert len(args) == len(_build._SIGNATURES[fn]) - 2
    pointers = [a for a in args if isinstance(a, type(ptr(None)))]
    assert len(pointers) == 20                 # no cos/sin arrays of the motion
    assert [a.value for a in args[20:25]] == [p, l, m, c, int(parity)]
    assert (args[-2].value, args[-1].value) == motion_launch_geometry(l, m, parity)
    assert (c, p) not in trig                  # the kernel takes cos/sin itself


def launcher_and_kernel():
    text = (_build.CSRC / "fused_update.cu").read_text()
    launcher = re.search(r"int fused_update_planes_multi_launch\(.*?\n}\n", text, re.S).group(0)
    kernel = re.search(r"__global__ void fused_update_planes_multi_kernel\(.*?\n}\n", text,
                       re.S).group(0)
    return launcher, kernel


def test_the_launcher_takes_the_per_tick_kernels_bytes_and_limits():
    launcher, kernel = launcher_and_kernel()
    text = (_build.CSRC / "fused_update.cu").read_text()
    tick = re.search(r"int fused_update_planes_launch\(.*?\n}\n", text, re.S).group(0)
    check = "checked_motion_shared_bytes(L, M, tile, lanes, parity != 0)"
    assert check in launcher and check in tick
    assert "if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);" in launcher
    assert "cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize" \
        in launcher
    assert "kernel<<<grid, tile * lanes, smem," in launcher
    assert "const dim3 grid((P + tile - 1) / tile);" in launcher
    # the launch geometry of every slot count both modes take is the one the
    # per-tick kernel takes, and its bytes are motion_shared_bytes'
    for parity, top in ((False, 256), (True, 512)):
        for l in (1, 16, 64, 200, top):
            tile, lanes = motion_launch_geometry(l, 16, parity)
            assert cuda_kernels.motion_shared_bytes(l, 16, tile, parity) == 4 * (
                (7 if parity else 6) * l * tile + (l + 31) // 32 * tile + tile + 5 * 16)
            assert tile * lanes % 32 == 0 and tile * lanes <= 1024


def test_the_kernel_stages_once_per_chunk():
    _, kernel = launcher_and_kernel()
    loop = kernel.index("for (int k = 0; k < C; ++k)")
    assert kernel.count("stage_tile<PARITY>(") == 1 and kernel.index("stage_tile<PARITY>(") < loop
    assert kernel.count("write_back<PARITY>(") == 1 and kernel.index("write_back<PARITY>(") > \
        kernel.index("atomicMax(&rows, cnt)") > loop
    assert "TileColumn<PARITY>" in kernel
    assert "cosf(nrot)" in kernel and "sinf(nrot)" in kernel
