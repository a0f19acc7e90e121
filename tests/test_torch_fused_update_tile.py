"""The per-tick motion kernel's staged tile, checked without a GPU.

``csrc/fused_update.cu`` runs the per-tick motion update over a tile of
particles staged in shared memory (``csrc/tile.cuh``), as the fs2 kernels
do, in production and in parity mode (a seventh plane, cc, and det(cov) in
place of 1/det).  Here, on the CPU:

* ``motion_launch_geometry`` gives every slot count a tile that fits the
  227 KB a block may opt into, in whole warps, and the byte count and limits
  are the ones the kernel launches with;
* the tile's swizzle is a permutation of each row's columns at every
  geometry the kernel takes (tiles below 32 included), and the staging
  threads write each (slot, column) once;
* the lanes' split scans (each lane's first hit or smallest key among slots
  g, g + G, ..., then the minimum over lanes) give the plain version's
  association on seeded maps;
* the plain version (what the kernel is held to on the card) equals the
  JAX Pallas kernel in interpret mode with maps that fill to L within the
  tick, at the 1e-5 of ``tests/test_pallas.py``;
* the wrapper launches with the geometry, in both modes.
"""

import re

import numpy as np
import pytest
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import _build, cuda_kernels
from fastslam_tpu_torch.core.cuda_kernels import motion_launch_geometry, motion_shared_bytes
from fastslam_tpu_torch.core.cuda_kernels.filter import (
    _INVALID_KEY, _STATIC_SMEM_BYTES, _initial_detp, _packed_argmin,
)

from test_torch_build import fake_library
from test_torch_fused_update import assert_update_matches, base_config, run_both, seeded_planes

torch.set_num_threads(1)

LIMIT = 232_448
# the geometries the kernel is timed at (chip_smoke.py phase 9) and the
# shrunken tiles the geometry function falls back to
GEOMETRIES = [(16, 8), (32, 2), (32, 4), (32, 8), (64, 2), (64, 4), (8, 4), (16, 16),
              (32, 32), (128, 1)]


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("m", [1, 16, 64])
def test_every_slot_count_gets_a_tile_that_fits(parity, m):
    top = 512 if parity else 256     # production: the packed key's 8 slot bits
    for l in range(1, top + 1):
        tile, lanes = motion_launch_geometry(l, m, parity)
        assert (tile % 32 == 0) or (tile < 32 and tile & (tile - 1) == 0), (l, tile)
        assert lanes <= min(tile, 32) and tile * lanes % 32 == 0, (l, tile, lanes)
        assert tile * lanes <= 1024
        staged = motion_shared_bytes(l, m, tile, parity)
        assert staged >= 4 * (7 if parity else 6) * l * tile
        assert staged + _STATIC_SMEM_BYTES <= LIMIT, (l, staged)
        if tile < cuda_kernels.MOTION_TILE:   # the largest tile that fits
            bigger = 2 * tile if tile < 32 else tile + 32
            assert motion_shared_bytes(l, m, bigger, parity) \
                + _STATIC_SMEM_BYTES > LIMIT
    assert motion_launch_geometry(64, m, parity) == (cuda_kernels.MOTION_TILE,
                                                     cuda_kernels.MOTION_LANES)


def test_parity_at_256_slots_still_stages_32_particles():
    assert motion_launch_geometry(256, 16, True)[0] == 32
    assert motion_shared_bytes(256, 16, 32, True) == 230_848


def test_a_block_that_cannot_fit_is_refused():
    with pytest.raises(ValueError, match="do not fit a 8-particle motion tile"):
        motion_launch_geometry(2000, 16, True)
    with pytest.raises(ValueError, match="at least one landmark slot"):
        motion_launch_geometry(0, 16, False)


def test_the_kernel_launches_with_the_same_bytes_and_limits():
    tile_h = (_build.CSRC / "tile.cuh").read_text()
    constant = lambda name: int(re.search(rf"{name} = (\d+);", tile_h).group(1))
    assert (constant("kPlanes"), constant("kParityPlanes")) == (6, 7)
    text = (_build.CSRC / "fused_update.cu").read_text()
    assert '#include "tile.cuh"' in text
    assert "tile_shared_bytes(L, M, tile, parity ? kParityPlanes : kPlanes)" in text
    assert "smem + kStaticSmemBytes > kSmemOptInLimit" in text
    for l, m, tile, parity in ((64, 16, 32, False), (64, 16, 32, True), (3, 1, 8, True)):
        planes = 7 if parity else 6
        assert motion_shared_bytes(l, m, tile, parity) == 4 * (
            planes * l * tile + (l + 31) // 32 * tile + tile + 5 * m)


def column(i, l, tile, lanes):
    """tile.cuh: TileColumn::at(l) for particle i, less the row offset."""
    group = min(tile, 32)
    shift = (group // lanes).bit_length() - 1
    return i ^ ((l & (lanes - 1)) << shift)


@pytest.mark.parametrize("tile,lanes", GEOMETRIES)
def test_the_swizzle_permutes_each_row(tile, lanes):
    l_max = 70
    for l in range(l_max):
        cols = [column(i, l, tile, lanes) for i in range(tile)]
        assert sorted(cols) == list(range(tile)), (l, cols)
    # stage_tile's thread (r, c) writes rows r, r + G, ... at c ^ (r << shift):
    # every (slot, column) once, at the column TileColumn reads
    seen = set()
    for thread in range(tile * lanes):
        c, r = thread % tile, thread // tile
        for l in range(r, l_max, lanes):
            col = c ^ (r << ((min(tile, 32) // lanes).bit_length() - 1))
            assert col == column(c, l, tile, lanes)
            seen.add((l, col))
    assert len(seen) == l_max * tile


def lanes_first_hit(hit, lanes):
    """Each lane's first hit among slots g, g + G, ..., then the smallest."""
    l = hit.shape[0]
    firsts = [next((s for s in range(g, l, lanes) if hit[s]), l) for g in range(lanes)]
    return min(firsts)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
def test_split_scans_give_the_plain_association(lanes):
    """On seeded maps (parity and production) the lanes' split scans pick the
    slot the plain version picks."""
    rng = np.random.default_rng(lanes)
    l, p = 40, 64
    for parity in (False, True):
        st = seeded_planes(p, l, seed=lanes, fill=l, parity=parity)
        t = {k: None if v is None else torch.from_numpy(v) for k, v in st.items()}
        cc = t["lm_cc"] if parity else t["lm_cb"]
        slot = torch.arange(l, dtype=torch.int32)[:, None]
        cnt = t["lm_count"].reshape(1, p)
        detp = _initial_detp(slot, cnt, t["lm_ca"], t["lm_cb"], cc, t["lm_cd"])
        qx, qy = (torch.tensor(v, dtype=torch.float32) for v in rng.normal(0, 3, 2))
        dx, dy = t["lm_mx"] - qx, t["lm_my"] - qy
        d2f = dx * (t["lm_cd"] * dx - t["lm_cb"] * dy) + dy * (-cc * dx + t["lm_ca"] * dy)
        gate = 9.0
        if parity:
            hit = (detp > 0.0) & (d2f < gate * gate * detp)
            want = torch.where(hit, slot, l).amin(dim=0)
            got = [lanes_first_hit(hit[:, i].numpy(), lanes) for i in range(p)]
        else:
            _, want = _packed_argmin(d2f, detp, slot, gate)
            usable = detp > 0.0
            key = torch.clamp_min(d2f * (1.0 / torch.where(usable, detp, 1.0)), 0.0)
            key = torch.where(usable, (key.view(torch.int32) & ~0xFF) | slot,
                              _INVALID_KEY)
            got = [min(int(key[g::lanes, i].min()) if g < l else _INVALID_KEY
                       for g in range(lanes)) & 0xFF for i in range(p)]
            want = want[0]
        assert got == want.tolist()


@pytest.mark.parametrize("parity", [False, True])
def test_plain_version_matches_jax_on_maps_filling_to_l(parity):
    """12 measurements, 11 valid, most of them new: maps with a few free
    slots fill to L=8 within the tick and then refuse appends, as the staged
    kernel must (JAX's planes take a multiple of 128 particles; the card
    tests add the ragged last tile)."""
    p, l, m = 256, 8, 12
    jcfg = base_config(parity, p, l, m)
    st = seeded_planes(p, l, seed=11, fill=6, parity=parity)
    rng = np.random.default_rng(12)
    z = np.zeros((m, 2), np.float32)
    z[:, 0] = rng.uniform(0.5, 6.0, m)
    z[:, 1] = rng.uniform(-3.0, 3.0, m)
    z_valid = np.ones(m, bool)
    z_valid[5] = False                                   # an interior hole
    want, got = run_both(st, z, z_valid, jcfg)
    assert_update_matches(want, got, parity)
    before, after = st["lm_count"], got[-1].numpy()
    assert ((before < l) & (after == l)).any()          # filled to L in the tick
    assert (after > before).any() and (after <= l).all()


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("l", [16, 64, 256])
def test_the_wrapper_launches_with_the_geometry(monkeypatch, parity, l):
    calls = fake_library(monkeypatch)
    p, m = 100, 16
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=l, max_measurements=m,
                         parity_mode=parity)
    launches = cuda_kernels.LAUNCHES["fused_update_planes"]
    cuda_kernels.fused_update_planes(
        meta(p, 3), meta(p), *(meta(l, p) for _ in range(4)),
        meta(l, p) if parity else None, meta(l, p), meta(p, dtype=torch.int32),
        meta(m, 2), meta(m, dtype=torch.bool), cfg)
    cuda_kernels.LAUNCHES["fused_update_planes"] = launches
    (fn, (_, *args, _)), = calls
    assert fn == "fused_update_planes_launch"
    assert [a.value for a in args[14:18]] == [p, l, m, int(parity)]
    assert (args[-2].value, args[-1].value) == motion_launch_geometry(l, m, parity)
