"""The fs2 kernels' launch geometry, checked without a GPU.

``fs2_launch_geometry`` picks the particles per block (the tile staged in
shared memory) and the lanes per particle from L and M.  For every L the
kernels take (1 to 256, the packed key's 8 slot bits) the tile is at least
32, the block a whole number of warps, and the staged planes and tables fit
the 227 KB a block may opt into; past that it raises.  The byte count and
limits are the ones ``csrc/fused_fs2.cu`` launches with.
"""

import re

import pytest

from fastslam_tpu_torch.core import _build, cuda_kernels
from fastslam_tpu_torch.core.cuda_kernels import fs2_launch_geometry, fs2_shared_bytes

LIMIT = 232_448


@pytest.mark.parametrize("m", [1, 16, 64])
def test_every_slot_count_gets_a_tile_that_fits(m):
    for l in range(1, 257):
        tile, lanes = fs2_launch_geometry(l, m)
        assert tile >= 32 and tile % 32 == 0, (l, tile)
        assert tile * lanes % 32 == 0 and tile * lanes <= 1024, (l, tile, lanes)
        staged = fs2_shared_bytes(l, m, tile)
        assert staged >= 4 * 6 * l * tile
        assert staged + cuda_kernels._STATIC_SMEM_BYTES <= LIMIT, (l, staged)
        # the largest tile that fits, up to the timed one
        if tile < cuda_kernels.FS2_TILE:
            assert fs2_shared_bytes(l, m, 2 * tile) + cuda_kernels._STATIC_SMEM_BYTES > LIMIT
    assert fs2_launch_geometry(64, m) == (cuda_kernels.FS2_TILE, cuda_kernels.FS2_LANES)
    assert fs2_launch_geometry(256, m)[0] == 32


@pytest.mark.parametrize("l", [0, 257, 1024])
def test_slot_counts_past_the_packed_key_are_refused(l):
    with pytest.raises(ValueError, match="1 to 256 landmark slots"):
        fs2_launch_geometry(l, 16)


def test_a_block_that_cannot_fit_is_refused():
    with pytest.raises(ValueError, match="do not fit a 32-particle fs2 tile"):
        fs2_launch_geometry(256, 2000)


@pytest.mark.parametrize("tile,lanes,want", [(128, 1, 128), (64, 2, 64), (256, 2, 128)])
def test_a_larger_tile_shrinks_only_to_fit(monkeypatch, tile, lanes, want):
    monkeypatch.setattr(cuda_kernels, "FS2_TILE", tile)
    monkeypatch.setattr(cuda_kernels, "FS2_LANES", lanes)
    assert fs2_launch_geometry(64, 16) == (want, lanes)
    assert fs2_launch_geometry(256, 16) == (32, lanes)


def test_the_kernels_launch_with_the_same_bytes_and_limits():
    # the staged tile's layout lives in csrc/tile.cuh, shared with the
    # per-tick motion kernel; the fs2 launchers use its production planes
    text = (_build.CSRC / "tile.cuh").read_text()
    constant = lambda name: int(re.search(rf"{name} = (\d+);", text).group(1))
    assert constant("kPlanes") == 6
    assert constant("kSmemOptInLimit") == LIMIT == cuda_kernels.SMEM_OPT_IN_BYTES
    assert constant("kStaticSmemBytes") == cuda_kernels._STATIC_SMEM_BYTES
    body = re.search(r"inline size_t tile_shared_bytes\([^)]*\) \{(.*?)\n\}", text, re.S)
    terms = re.sub(r"static_cast<size_t>|\s", "", body.group(1))
    # the same sum as fs2_shared_bytes: planes, written bits, counts, tables
    assert terms == "return((planes)*L*T+((L+31)/32)*T+T+5*(M))*sizeof(float);"
    fs2 = (_build.CSRC / "fused_fs2.cu").read_text()
    assert '#include "tile.cuh"' in fs2
    assert "tile_shared_bytes(L, M, tile)" in fs2   # the default: kPlanes
