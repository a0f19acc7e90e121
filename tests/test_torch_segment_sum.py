"""The deterministic segment sum (``core/cuda_kernels.py:segment_sum``), the
port-only kernel of the pose-graph backend, through its plain version.

* Against a float64 segment sum within 1e-6 of each segment's sum of
  magnitudes, on ragged, skewed and empty segments, with and without a
  permutation, one and several columns.  The sums are float64.
* The plain version adds in the kernel's order and precision (lane
  ``j % 32`` of a warp takes entry ``j`` of its segment, lanes add their
  entries in turn in float64, then the halving tree over the 32 lanes): it
  equals a numpy transcription of that order bit for bit.
* ``segment_layout`` groups the valid entries by segment in index order.
The kernel against this plain version, bit for bit, is in
``tests/test_torch_cuda.py`` (card only).
"""

import numpy as np
import pytest
import torch

from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.core.cuda_kernels import (
    Segments, _check_segment_inputs, segment_layout, segment_sum, segment_sum_ref,
)

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
    perm, offsets = segment_layout(torch.tensor(index, dtype=torch.int32),
                                   torch.tensor(valid), s)
    assert perm.dtype == torch.int32 and offsets.dtype == torch.int32
    assert offsets.shape == (s + 1,) and int(offsets[0]) == 0
    assert int(offsets[-1]) == valid.sum()
    for seg in range(s):
        members = perm[offsets[seg]:offsets[seg + 1]].numpy()
        np.testing.assert_array_equal(members, np.flatnonzero(valid & (index == seg)))
    # no valid mask: every entry belongs to its segment
    perm_all, offsets_all = segment_layout(torch.tensor(index), None, s)
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


@pytest.mark.parametrize("bad", ["dtype", "perm_dtype", "too_many_entries"])
def test_kernel_input_checks(bad):
    values = torch.zeros((2, 8))
    layout = Segments(torch.zeros(8, dtype=torch.int32), torch.tensor([0, 8], dtype=torch.int32))
    if bad == "dtype":
        values = values.double()
    elif bad == "perm_dtype":
        layout = layout._replace(perm=layout.perm.long())
    else:
        layout = layout._replace(perm=torch.zeros(9, dtype=torch.int32))
    with pytest.raises(ValueError):
        _check_segment_inputs(values, layout)
