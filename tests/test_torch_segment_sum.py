"""The deterministic segment sum (``core/cuda_kernels/segment_sum.py:segment_sum``), the
port-only kernel of the pose-graph backend, through its plain version.

* Against a float64 segment sum within 1e-6 of each segment's sum of
  magnitudes, on ragged, skewed and empty segments, with and without a
  permutation, one and several columns.  The sums are float64.
* The plain version adds in the kernel's order and precision (lane
  ``j % 32`` of a warp takes entry ``j`` of its segment, lanes add their
  entries in turn in float64, then the halving tree over the 32 lanes): it
  equals a numpy transcription of that order bit for bit.
* ``segment_layout`` groups the valid entries by segment in index order.
* A numpy model of the kernel's schedule (``csrc/segment_sum.cu``: a lane
  per short segment with the tree's empty lanes elided, a warp per long
  segment and column, the launcher's grid) writes every sum once and gives
  the plain order's bits, for every segment length 0-40, 63-65 and 1000,
  on signed zeros, infinities and mixed magnitudes.
* ``long_segments`` lists the long segments; a hand-built two-tensor
  layout still sums.
The kernel against this plain version, bit for bit, is in
``tests/test_torch_cuda.py`` (card only).
"""

import re

import numpy as np
import pytest
import torch

from fastslam_tpu_torch.core import _build, cuda_kernels
from fastslam_tpu_torch.core.cuda_kernels import (
    SEGMENT_LANES, SHORT_SEGMENT, Segments, long_segments, segment_layout, segment_sum,
    segment_sum_ref,
)
from fastslam_tpu_torch.core.cuda_kernels.segment_sum import _check_segment_inputs

torch.set_num_threads(1)


def case(name, seed=0):
    """(index [n], valid [n], num_segments, values [C, n]) of a named case."""
    rng = np.random.default_rng(seed)
    if name == "ragged":
        n, s = 2000, 97
        index = rng.integers(0, s, n)
        valid = rng.random(n) < 0.85
    elif name == "empty_segments":
        n, s = 500, 400                      # most segments empty
        index = rng.choice([3, 7, 8, 250, 399], n)
        valid = np.ones(n, bool)
    elif name == "skewed":
        n, s = 6000, 50                      # one segment of ~5000 entries
        index = np.where(rng.random(n) < 0.83, 17, rng.integers(0, s, n))
        valid = rng.random(n) < 0.97
    elif name == "one_segment":
        n, s = 1000, 1
        index = np.zeros(n, np.int64)
        valid = np.ones(n, bool)
    elif name == "no_entries":
        n, s = 64, 10
        index = rng.integers(0, s, n)
        valid = np.zeros(n, bool)
    else:
        raise ValueError(name)
    values = (rng.normal(0, 1, (3, n)) * rng.choice([1e-3, 1.0, 1e3], (3, n))).astype(np.float32)
    return index, valid, s, values


CASES = ("ragged", "empty_segments", "skewed", "one_segment", "no_entries")


def float64_sums(index, valid, s, values):
    out = np.zeros((values.shape[0], s))
    mag = np.zeros((values.shape[0], s))
    for c in range(values.shape[0]):
        np.add.at(out[c], index[valid], values[c][valid].astype(np.float64))
        np.add.at(mag[c], index[valid], np.abs(values[c][valid].astype(np.float64)))
    return out, mag


def lane_order_sums(index, valid, s, values):
    """The kernel's order in float64 numpy: per segment its entries in index
    order, lane j % 32, sequential per lane from 0, then the halving tree."""
    out = np.zeros((values.shape[0], s))
    for seg in range(s):
        members = np.flatnonzero(valid & (index == seg))
        for c in range(values.shape[0]):
            lanes = np.zeros(32)
            for j, m in enumerate(members):
                lanes[j % 32] = lanes[j % 32] + np.float64(values[c, m])
            while len(lanes) > 1:
                h = len(lanes) // 2
                lanes = lanes[:h] + lanes[h:]
            out[c, seg] = lanes[0]
    return out


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("columns", [1, 3])
def test_plain_matches_float64(name, columns):
    index, valid, s, values = case(name)
    values = values[:columns]
    layout = segment_layout(torch.tensor(index), torch.tensor(valid), s)
    got = segment_sum(torch.tensor(values), layout).numpy()
    want, mag = float64_sums(index, valid, s, values)
    assert got.shape == (columns, s) and got.dtype == np.float64
    assert (np.abs(got - want) <= 1e-6 * mag + 1e-30).all()
    assert (got[:, mag[0] == 0] == 0).all()          # empty segments sum to 0


@pytest.mark.parametrize("name", ("ragged", "skewed", "empty_segments"))
def test_plain_adds_in_the_kernels_order(name):
    index, valid, s, values = case(name, seed=1)
    layout = segment_layout(torch.tensor(index), torch.tensor(valid), s)
    got = segment_sum_ref(torch.tensor(values), layout).numpy()
    np.testing.assert_array_equal(got, lane_order_sums(index, valid, s, values))


def test_layout_groups_valid_entries_in_index_order():
    index, valid, s, _ = case("ragged", seed=2)
    perm, offsets, _ = segment_layout(torch.tensor(index, dtype=torch.int32),
                                      torch.tensor(valid), s)
    assert perm.dtype == torch.int32 and offsets.dtype == torch.int32
    assert offsets.shape == (s + 1,) and int(offsets[0]) == 0
    assert int(offsets[-1]) == valid.sum()
    for seg in range(s):
        members = perm[offsets[seg]:offsets[seg + 1]].numpy()
        np.testing.assert_array_equal(members, np.flatnonzero(valid & (index == seg)))
    # no valid mask: every entry belongs to its segment
    perm_all, offsets_all, _ = segment_layout(torch.tensor(index), None, s)
    assert int(offsets_all[-1]) == len(index)


def test_identity_layout_and_one_column():
    values = torch.arange(10, dtype=torch.float32)
    layout = Segments(torch.arange(10, dtype=torch.int32),
                      torch.tensor([0, 3, 3, 10], dtype=torch.int32))
    out = segment_sum(values, layout)
    assert out.shape == (3,)
    np.testing.assert_array_equal(out.numpy(), [3.0, 0.0, 42.0])


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    index, valid, s, values = case("ragged", seed=3)
    layout = segment_layout(torch.tensor(index), torch.tensor(valid), s)
    before = cuda_kernels.LAUNCHES["segment_sum"]
    got = segment_sum(torch.tensor(values), layout)
    assert cuda_kernels.LAUNCHES["segment_sum"] == before
    assert torch.equal(got, segment_sum_ref(torch.tensor(values), layout))


@pytest.mark.parametrize("bad", ["dtype", "perm_dtype", "too_many_entries", "long_dtype",
                                 "long_shape"])
def test_kernel_input_checks(bad):
    values = torch.zeros((2, 8))
    layout = Segments(torch.zeros(8, dtype=torch.int32), torch.tensor([0, 8], dtype=torch.int32))
    if bad == "dtype":
        values = values.double()
    elif bad == "perm_dtype":
        layout = layout._replace(perm=layout.perm.long())
    elif bad == "long_dtype":
        layout = layout._replace(long=long_segments(layout.offsets).long())
    elif bad == "long_shape":
        layout = layout._replace(long=torch.zeros(3, dtype=torch.int32))
    else:
        layout = layout._replace(perm=torch.zeros(9, dtype=torch.int32))
    with pytest.raises(ValueError):
        _check_segment_inputs(values, layout)



# ---------------------------------------------------------------------------
# a numpy model of csrc/segment_sum.cu's schedule
# ---------------------------------------------------------------------------

def kernel_constants():
    """(warps per block, threads per block, LONG_SLOTS_PER_SM,
    LONG_MIN_PER_SM) of ``csrc/segment_sum.cu``, after checking its lane and
    short-segment constants against the wrapper's."""
    text = (_build.CSRC / "segment_sum.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("SEG_LANES") == SEGMENT_LANES == 32
    assert const("SHORT_MAX") == SHORT_SEGMENT
    return (const("SEG_THREADS") // 32, const("SEG_THREADS"), const("LONG_SLOTS_PER_SM"),
            const("LONG_MIN_PER_SM"))


def short_lane(vals, n_class):
    """``lane_sum<N>``: leaves ``0.0 + v`` in the slots ``j < len`` of
    ``n_class``, then the tree's levels h = N/2, ..., 1, an add skipped
    where its right slot ``l + h`` holds no entry."""
    length = len(vals)
    x = [np.float64(0.0) + np.float64(v) for v in vals] + [np.float64(0.0)] * (n_class - length)
    h = n_class // 2
    while h >= 1:
        for l in range(h):
            if l + h < length:
                x[l] = x[l] + x[l + h]
        h //= 2
    return x[0]


def long_warp(vals):
    """``long_tasks``: lane ``j % 32`` adds entry ``j`` in turn from 0.0,
    then the butterfly ``x_l + x_{l ^ h}`` on all lanes; lane 0's value."""
    lanes = [np.float64(0.0)] * SEGMENT_LANES
    for j, v in enumerate(vals):
        lanes[j % SEGMENT_LANES] = lanes[j % SEGMENT_LANES] + np.float64(v)
    for h in (16, 8, 4, 2, 1):
        lanes = [lanes[l] + lanes[l ^ h] for l in range(SEGMENT_LANES)]
    return lanes[0]


def kernel_model(values, perm, offsets, long_list, sms=132):
    """The launch block by block: the launcher's long blocks (the slots the
    tile blocks leave; their warps striding over the (long segment, column)
    tasks), then a warp per tile of 32 segments whose class N is the power
    of two at or above its longest short segment.  Returns the sums and each
    sum's write count."""
    warps_per_block, threads, slots, least = kernel_constants()
    c_n, n = values.shape
    s_n = len(offsets) - 1
    out = np.full((c_n, s_n), np.nan)
    writes = np.zeros((c_n, s_n), np.int64)
    tile_blocks = -(-s_n // threads)
    most_long = min(n // (SHORT_SEGMENT + 1), s_n)
    long_blocks = min(max(sms * slots - tile_blocks, sms * least),
                      -(-most_long * c_n // warps_per_block))
    warps, tasks = long_blocks * warps_per_block, int(long_list[0]) * c_n
    for warp in range(warps):
        for t in range(warp, tasks, warps):
            seg, c = int(long_list[1 + t // c_n]), t % c_n
            out[c, seg] = long_warp(values[c, perm[offsets[seg]:offsets[seg + 1]]])
            writes[c, seg] += 1
    for s0 in range(0, s_n, SEGMENT_LANES):
        segs = range(s0, min(s0 + SEGMENT_LANES, s_n))
        lens = [int(offsets[s + 1] - offsets[s]) for s in segs]
        longest = max([ln for ln in lens if ln <= SHORT_SEGMENT], default=0)
        n_class = 1 << max(longest - 1, 0).bit_length()
        for s, ln in zip(segs, lens):
            if ln > SHORT_SEGMENT:
                continue
            for c in range(c_n):
                out[c, s] = short_lane(values[c, perm[offsets[s]:offsets[s + 1]]], n_class)
                writes[c, s] += 1
    return out, writes


LENGTHS = list(range(41)) + [63, 64, 65, 1000]
KINDS = ("mixed", "signed_zeros", "infinities", "negative_zeros")


def kinds_of_values(n, rng):
    """float32 [4, n]: one column per kind of :data:`KINDS`."""
    mixed = rng.normal(0, 1, n) * rng.choice([1e-3, 1.0, 1e3], n)
    zeros = rng.choice([-0.0, 0.0, 1.5, -1.5], n)        # sums that cancel to 0 exactly
    infs = np.where(rng.random(n) < 0.1, rng.choice([-np.inf, np.inf], n), mixed)
    return np.stack([mixed, zeros, infs, np.full(n, -0.0)]).astype(np.float32)


def bits(x):
    return np.asarray(x, np.float64).view(np.uint64)


def model_case(lengths, seed):
    """(index, valid, s, values, layout) of segments of the given lengths,
    their entries interleaved at random."""
    rng = np.random.default_rng(seed)
    index = rng.permutation(np.repeat(np.arange(len(lengths)), lengths))
    values = kinds_of_values(max(len(index), 1), rng)[:, :len(index)]
    valid = np.ones(len(index), bool)
    layout = segment_layout(torch.tensor(index, dtype=torch.int64), None, len(lengths))
    return index, valid, len(lengths), values, layout


@pytest.mark.filterwarnings("ignore:invalid value encountered:RuntimeWarning")
@pytest.mark.parametrize("length", LENGTHS)
def test_kernel_model_adds_in_the_plain_order(length):
    """Three segments of one length, one column per kind of value: the
    model's bits (the sign of zero included) equal the plain order's, and
    every sum is written once; each short lane gives the same bits at every
    class N from its own up to 32."""
    index, valid, s, values, layout = model_case([length] * 3, seed=length)
    want = lane_order_sums(index, valid, s, values)
    got, writes = kernel_model(values, layout.perm.numpy(), layout.offsets.numpy(),
                               layout.long.numpy())
    np.testing.assert_array_equal(bits(got), bits(want))
    assert (writes == 1).all()
    np.testing.assert_array_equal(bits(segment_sum_ref(torch.tensor(values), layout)),
                                  bits(want))
    if 0 < length <= SEGMENT_LANES:          # the lane's tree is exact up to 32 entries
        perm, offsets = layout.perm.numpy(), layout.offsets.numpy()
        for n_class in (1 << k for k in range(6) if 1 << k >= length):
            for c in range(values.shape[0]):
                for seg in range(s):
                    vals = values[c, perm[offsets[seg]:offsets[seg + 1]]]
                    assert bits(short_lane(vals, n_class)) == bits(want[c, seg])
    if length == 0:
        assert (bits(got) == 0).all()                    # +0.0, written
    assert (bits(want[3]) == 0).all()                     # sums of -0.0 are +0.0


@pytest.mark.filterwarnings("ignore:invalid value encountered:RuntimeWarning")
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_model_on_tiles_of_mixed_lengths(seed, sms):
    """Every length of :data:`LENGTHS` twice in one shuffled layout, so
    that tiles of 32 segments mix classes, long and empty segments; on one
    SM the long warps take several tasks each."""
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(LENGTHS * 2)
    index, valid, s, values, layout = model_case(lengths, seed)
    want = lane_order_sums(index, valid, s, values)
    got, writes = kernel_model(values, layout.perm.numpy(), layout.offsets.numpy(),
                               layout.long.numpy(), sms=sms)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert (writes == 1).all()


@pytest.mark.parametrize("name", CASES)
def test_kernel_model_matches_plain(name):
    index, valid, s, values = case(name, seed=4)
    layout = segment_layout(torch.tensor(index), torch.tensor(valid), s)
    got, writes = kernel_model(values, layout.perm.numpy(), layout.offsets.numpy(),
                               layout.long.numpy())
    assert (writes == 1).all()
    np.testing.assert_array_equal(bits(got),
                                  bits(segment_sum_ref(torch.tensor(values), layout)))


@pytest.mark.parametrize("name", CASES + ("lengths",))
def test_long_segments_lists_the_long_ones_in_order(name):
    if name == "lengths":
        index, valid, s, _, _ = model_case(LENGTHS, 5)
    else:
        index, valid, s, _ = case(name, seed=5)
    layout = segment_layout(torch.tensor(index), torch.tensor(valid), s)
    counts = np.diff(layout.offsets.numpy())
    long = layout.long.numpy()
    assert layout.long.dtype == torch.int32 and long.shape == (s + 1,)
    want = np.flatnonzero(counts > SHORT_SEGMENT)
    assert long[0] == len(want)
    np.testing.assert_array_equal(long[1:1 + len(want)], want)
    np.testing.assert_array_equal(long[1 + len(want):], np.flatnonzero(counts <= SHORT_SEGMENT))
    assert torch.equal(long_segments(layout.offsets), layout.long)


@pytest.mark.filterwarnings("ignore:invalid value encountered:RuntimeWarning")
def test_hand_built_two_tensor_layout_sums():
    """A layout of perm and offsets alone (``long`` None) passes the kernel's
    checks and sums; the wrapper lists its long segments on each call."""
    perm = torch.tensor(np.random.default_rng(6).permutation(120), dtype=torch.int32)
    offsets = torch.tensor([0, 3, 3, 80, 120], dtype=torch.int32)   # short, empty, long, long
    layout = Segments(perm, offsets)
    assert layout.long is None and layout.num_segments == 4
    values = torch.tensor(kinds_of_values(120, np.random.default_rng(7)))
    _check_segment_inputs(values, layout)
    got = segment_sum(values, layout)
    np.testing.assert_array_equal(bits(got), bits(segment_sum_ref(values, layout)))
    long = long_segments(offsets)
    np.testing.assert_array_equal(long.numpy(), [2, 2, 3, 0, 1])
    model, writes = kernel_model(values.numpy(), perm.numpy(), offsets.numpy(), long.numpy())
    np.testing.assert_array_equal(bits(model), bits(got.numpy()))
    assert (writes == 1).all()


def test_gather_sectors_counts_the_warp_loads():
    """``probes/segment_sum_turns.py:gather_sectors``: contiguous loads of
    32 floats touch 4 sectors; a stride of 8 floats puts each in its own."""
    from fastslam_tpu_torch.probes.segment_sum_turns import gather_sectors

    one_long = Segments(torch.arange(64, dtype=torch.int32), torch.tensor([0, 64],
                                                                          dtype=torch.int32))
    assert gather_sectors(one_long, SHORT_SEGMENT) == {"sectors_per_load": 4.0,
                                                       "sector_mb": 8 * 32 / 1e6}
    short = Segments(torch.arange(32, dtype=torch.int32) * 8,
                     torch.arange(33, dtype=torch.int32))      # a tile of 1-entry segments
    assert gather_sectors(short, SHORT_SEGMENT)["sectors_per_load"] == 32.0
