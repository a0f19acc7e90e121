"""The device-decided systematic resample of the planes layout and its
plain versions (:func:`resample_staircase`, :func:`resample_gather`,
``csrc/resample.cu``), a port-only pair in place of the JAX package's
resample under ``lax.cond``: the staircase of ancestors from the weights,
and the in-place ancestor gather of the state, both reading the decision
in device memory and doing nothing where no resample is due.
"""

from __future__ import annotations

import ctypes

import torch

from fastslam_tpu_torch.core.cuda_kernels._launch import launch, ptr, require_cuda

# weights a block of the staircase scans (csrc/resample.cu SCAN_TILE)
RESAMPLE_SCAN_TILE = 4096
# the most buffers one gather takes (csrc/resample.cu MAX_BUFFERS): six
# planes, poses, counts and weights in parity mode
RESAMPLE_MAX_BUFFERS = 10
# scratch offsets, in 32-bit words (256 bytes)
_RESAMPLE_ALIGN = 64


def resample_staircase_ref(weights: torch.Tensor, u0: torch.Tensor,
                           due: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`resample_staircase`: the rounded exact
    cumulative sum (``kernels.fixed_order_cumsum``), the grid counts
    ``s`` (``kernels.grid_counts``), and for each ``m`` the first ``j``
    with ``s_j > m``, ``P - 1`` past ``s_{P-1}`` (the kernel's binary
    search, as ``searchsorted(s, m, right=True)``).  It computes the indices
    whatever ``due`` says."""
    from fastslam_tpu_torch.core import kernels

    n = weights.shape[0]
    s = kernels.grid_counts(kernels.fixed_order_cumsum(weights), u0, n)
    m = torch.arange(n, dtype=torch.int64, device=weights.device)
    return torch.clamp_max(torch.searchsorted(s, m, right=True), n - 1)


def resample_gather_ref(planes, per_particle, idx: torch.Tensor, due: torch.Tensor) -> None:
    """Plain version of :func:`resample_gather`: where ``due`` holds, each
    plane gathered along dim 1 and each per-particle tensor along dim 0,
    written back in place."""
    if bool(due):
        for t in planes:
            t.copy_(t.index_select(1, idx))
        for t in per_particle:
            t.copy_(t.index_select(0, idx))


def _check_due(due, device):
    if due.dtype != torch.bool or due.numel() != 1 or due.device != device:
        raise ValueError(f"the resample decision is one bool on {device}, got {due.dtype} "
                         f"{tuple(due.shape)} on {due.device}")


def resample_staircase(weights: torch.Tensor, u0: torch.Tensor,
                       due: torch.Tensor) -> torch.Tensor:
    """The systematic resample's ancestors, where the device bool ``due``
    holds.

    Args:
      weights: float32 ``[P]``, ``exp`` of the normalized log-weights.
      u0: float32, one value in ``[0, 1/P)``, on the same device.
      due: bool, one value on the same device: whether a resample is due.

    Returns int64 ``[P]``: bit-identical to
    ``kernels.grid_staircase_indices(kernels.fixed_order_cumsum(weights),
    u0, P)`` on the same device where ``due`` holds; where it does not, the
    kernels write nothing and the values are undefined.  On CUDA one call of
    ``resample_staircase_launch`` (three kernels, each returning at once
    where ``due`` is false) and no host sync.
    """
    if weights.device.type == "cpu":
        return resample_staircase_ref(weights, u0, due)
    device = require_cuda(weights, u0, due)
    if weights.dim() != 1 or weights.dtype != torch.float32:
        raise ValueError(f"the staircase takes float32 [P] weights, got {weights.dtype} "
                         f"{tuple(weights.shape)}")
    if u0.dtype != torch.float32 or u0.numel() != 1 or u0.device != device:
        raise ValueError("u0 is one float32 on the weights' device")
    _check_due(due, device)
    p = weights.shape[0]
    if p >= 2 ** 31:
        raise ValueError("the staircase takes fewer than 2^31 weights")
    tiles = -(-p // RESAMPLE_SCAN_TILE)
    tile_sums = torch.empty(tiles, dtype=torch.int64, device=device)
    counts = torch.empty(p, dtype=torch.int32, device=device)
    idx = torch.empty(p, dtype=torch.int64, device=device)
    launch("resample_staircase", device, ptr(weights), ptr(u0),
           ptr(due), ptr(tile_sums), ptr(counts), ptr(idx), ctypes.c_int(p))
    return idx


def _resample_buffers(planes, per_particle, p: int):
    """``(tensor, rows, width)`` of each buffer: a plane ``[R, P]`` is R
    rows of width 1, a per-particle ``[P]`` or ``[P, W]`` one row of width 1
    or W; each of 32-bit words, contiguous."""
    out = []
    for t in planes:
        if t.dim() != 2 or t.shape[1] != p:
            raise ValueError(f"a plane is [R, {p}], got {tuple(t.shape)}")
        out.append((t, t.shape[0], 1))
    for t in per_particle:
        if t.dim() not in (1, 2) or t.shape[0] != p:
            raise ValueError(f"a per-particle tensor is [{p}] or [{p}, W], got {tuple(t.shape)}")
        out.append((t, 1, 1 if t.dim() == 1 else t.shape[1]))
    if not 1 <= len(out) <= RESAMPLE_MAX_BUFFERS:
        raise ValueError(f"the gather takes 1 to {RESAMPLE_MAX_BUFFERS} buffers, got {len(out)}")
    for t, _, _ in out:
        if t.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"the gather takes float32 and int32 buffers, got {t.dtype}")
        if t.numel() == 0 or t.numel() >= 2 ** 31:
            raise ValueError("a gathered buffer holds 1 to 2^31 - 1 values")
    return out


def resample_gather(planes, per_particle, idx: torch.Tensor, due: torch.Tensor) -> None:
    """The ancestor gather of a state, in place, where the device bool
    ``due`` holds.

    Args:
      planes: ``[R, P]`` tensors, gathered along dim 1 (the landmark planes).
      per_particle: ``[P]`` or ``[P, W]`` tensors, gathered along dim 0
        (poses, counts, parity weights).  Every buffer float32 or int32,
        contiguous, on one device; at most :data:`RESAMPLE_MAX_BUFFERS`.
      idx: int64 ``[P]`` ancestors in ``[0, P)``, non-decreasing
        (:func:`resample_staircase`); read only where ``due`` holds.
      due: bool, one value on the same device.

    Writes ``t[..., m] = t[..., idx[m]]`` into every buffer where ``due``
    holds, and touches no buffer where it does not.  On CUDA one call of
    ``resample_gather_launch``: a gather into a scratch of the buffers'
    shape, then its copy back, both returning at once where ``due`` is
    false; no host sync.  The scratch comes from ``torch.empty`` (inside a
    captured CUDA graph, from the graph's pool).
    """
    planes, per_particle = list(planes), list(per_particle)
    first = (planes or per_particle)[0]
    if first.device.type == "cpu":
        resample_gather_ref(planes, per_particle, idx, due)
        return
    p = idx.shape[0]
    buffers = _resample_buffers(planes, per_particle, p)
    device = require_cuda(*(t for t, _, _ in buffers), idx, due)
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise ValueError(f"ancestors are int64 [P], got {idx.dtype} {tuple(idx.shape)}")
    if any(t.device != device for t, _, _ in buffers) or idx.device != device:
        raise ValueError("the gather's buffers and ancestors must be on one device")
    _check_due(due, device)
    sizes = [-(-t.numel() // _RESAMPLE_ALIGN) * _RESAMPLE_ALIGN for t, _, _ in buffers]
    scratch = torch.empty(sum(sizes), dtype=torch.int32, device=device)
    offsets = [0]
    for n in sizes[:-1]:
        offsets.append(offsets[-1] + n)
    count = len(buffers)
    pointers = lambda values: (ctypes.c_void_p * count)(*values)
    ints = lambda values: (ctypes.c_int * count)(*values)
    src = pointers(t.data_ptr() for t, _, _ in buffers)
    dst = pointers(scratch.data_ptr() + 4 * o for o in offsets)
    rows, widths = ints(r for _, r, _ in buffers), ints(w for _, _, w in buffers)
    launch(
        "resample_gather", device,
        ctypes.c_void_p(ctypes.addressof(src)), ctypes.c_void_p(ctypes.addressof(dst)),
        ctypes.c_void_p(ctypes.addressof(rows)), ctypes.c_void_p(ctypes.addressof(widths)),
        ctypes.c_int(count), ptr(idx), ptr(due), ctypes.c_int(p))
