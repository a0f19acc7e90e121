"""The deterministic segment sums of the pose-graph backend and their plain
version (:func:`segment_sum`, ``csrc/segment_sum.cu``), a port-only kernel
in place of XLA's float scatter-adds: C float32 value columns summed in
float64 over the segments of a CSR layout (:func:`segment_layout`), one
warp per segment in one fixed order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from fastslam_tpu_torch.core.cuda_kernels._launch import launch, ptr, require_cuda

# lanes of a warp, whose order the sums follow (csrc/segment_sum.cu)
SEGMENT_LANES = 32
# the most entries of a segment that one lane of the kernel sums (SHORT_MAX);
# a longer one is a warp's per column (csrc/segment_sum.cu)
SHORT_SEGMENT = 8


class Segments(NamedTuple):
    """A CSR segment layout: segment ``s`` owns entries ``offsets[s]`` ..
    ``offsets[s + 1] - 1`` of ``perm``, each the index of a value within a
    column.  ``perm`` int32 ``[n]`` (entries past ``offsets[-1]`` are
    unused), ``offsets`` int32 ``[S + 1]``, ``long`` int32 ``[S + 1]`` or
    None: :func:`long_segments` of ``offsets``, which :func:`segment_sum`
    builds on each call where it is None."""

    perm: torch.Tensor
    offsets: torch.Tensor
    long: Optional[torch.Tensor] = None

    @property
    def num_segments(self) -> int:
        return self.offsets.shape[0] - 1


def long_segments(offsets: torch.Tensor) -> torch.Tensor:
    """int32 ``[S + 1]``: the number of segments of more than
    :data:`SHORT_SEGMENT` entries, then their ids in order (the rest of the
    tensor the other segments' ids).  The kernel hands each of them to a
    warp per column.  Torch ops only, with no host sync."""
    counts = offsets[1:] - offsets[:-1]
    is_long = counts > SHORT_SEGMENT
    order = torch.sort((~is_long).to(torch.uint8), stable=True).indices
    return torch.cat([is_long.sum().reshape(1), order]).to(torch.int32)


def segment_layout(index: torch.Tensor, valid: Optional[torch.Tensor],
                   num_segments: int) -> Segments:
    """The layout that groups the entries ``i`` with ``valid[i]`` by
    ``index[i]`` in ``[0, num_segments)``, each segment's entries in index
    order (a stable sort); invalid entries belong to no segment; with its
    :func:`long_segments`.  Torch ops only, on the device of ``index``, with
    no host sync: a graph builds it once and sums through it every
    iteration."""
    key = index.long()
    if valid is not None:
        key = torch.where(valid, key, num_segments)
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=torch.int64, device=index.device)
    offsets = torch.searchsorted(sorted_key, bounds).to(torch.int32)
    return Segments(order.to(torch.int32), offsets, long_segments(offsets))


def segment_sum_ref(values: torch.Tensor, segments: Segments) -> torch.Tensor:
    """Plain version of :func:`segment_sum`, in the kernel's order and
    precision: entry ``j`` of a segment goes to lane ``j % 32``, each lane
    adds its entries in turn from 0.0 in float64, then the 32 lane partials
    are added by the halving tree ``x[l] + x[l + h]``, h = 16, ..., 1
    (``kernels.tree_sum``; the kernel's ``__shfl_xor_sync`` tree adds the
    same pairs).  Lanes of all segments advance together, one round of 32
    entries at a time, by an ``index_put_`` without accumulation (each
    (segment, lane) takes at most one entry a round)."""
    from fastslam_tpu_torch.core.kernels import tree_sum

    c = values.shape[0]
    device = values.device
    s = segments.num_segments
    offsets = segments.offsets.long()
    e = int(offsets[-1])
    acc = torch.zeros((c, s * SEGMENT_LANES), dtype=torch.float64, device=device)
    if e:
        counts = offsets[1:] - offsets[:-1]
        seg = torch.repeat_interleave(torch.arange(s, device=device), counts,
                                      output_size=e)
        pos = torch.arange(e, device=device) - offsets[:-1][seg]
        slot = seg * SEGMENT_LANES + pos % SEGMENT_LANES
        rnd = pos // SEGMENT_LANES
        by_round = torch.sort(rnd, stable=True).indices
        rounds = int(rnd.max()) + 1
        starts = torch.searchsorted(rnd[by_round], torch.arange(rounds + 1, device=device))
        src = values[:, segments.perm[:e].long()].double()
        for lo, hi in zip(starts[:-1].tolist(), starts[1:].tolist()):
            sel = by_round[lo:hi]
            idx = slot[sel]
            acc[:, idx] = acc[:, idx] + src[:, sel]
    return tree_sum(acc.view(c, s, SEGMENT_LANES))


def _check_segment_inputs(values, segments: Segments):
    if values.dim() != 2 or values.dtype != torch.float32:
        raise ValueError(f"segment_sum takes float32 [C, n] values, got {values.dtype} "
                         f"{tuple(values.shape)}")
    perm, offsets, long = segments
    if perm.dtype != torch.int32 or offsets.dtype != torch.int32 or perm.dim() != 1 \
            or offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError("a segment layout is int32 perm [n] and int32 offsets [S + 1]")
    if long is not None and (long.dtype != torch.int32 or long.shape != offsets.shape):
        raise ValueError("a layout's long segments are int32 [S + 1]")
    if perm.shape[0] > values.shape[1]:
        raise ValueError(f"{perm.shape[0]} layout entries for columns of {values.shape[1]}")
    if any(t is not None and t.device != values.device for t in segments):
        raise ValueError("values and layout must be on one device")
    if values.numel() >= 2 ** 31 or offsets.shape[0] >= 2 ** 31:
        raise ValueError("segment_sum takes fewer than 2^31 values and segments")


def segment_sum(values: torch.Tensor, segments: Segments) -> torch.Tensor:
    """Sums of value columns over the segments of a layout, in one fixed order.

    Args:
      values: float32 ``[C, n]`` (or ``[n]``, one column), contiguous; the
        entries of ``segments.perm`` index its columns.
      segments: a :class:`Segments` layout (:func:`segment_layout`) on the
        same device.

    Returns float64 ``[C, S]`` (or ``[S]``): column ``c``'s sum over each
    segment, accumulated in float64, 0.0 for an empty one; the same bits on
    every run and equal to :func:`segment_sum_ref` bit for bit.  On CUDA one
    launch of ``segment_sum_kernel``, which writes every sum (no fill), and
    no host sync.
    """
    squeeze = values.dim() == 1
    values = values[None] if squeeze else values
    if values.device.type == "cpu":
        out = segment_sum_ref(values, segments)
        return out[0] if squeeze else out
    _check_segment_inputs(values, segments)
    long = segments.long if segments.long is not None else long_segments(segments.offsets)
    device = require_cuda(values, segments.perm, segments.offsets, long)
    c, n = values.shape
    s = segments.num_segments
    out = torch.empty((c, s), dtype=torch.float64, device=device)
    launch("segment_sum", device, ptr(values), ptr(segments.perm),
           ptr(segments.offsets), ptr(long), ptr(out), ctypes.c_int(c), ctypes.c_int(n),
           ctypes.c_int(s))
    return out[0] if squeeze else out
