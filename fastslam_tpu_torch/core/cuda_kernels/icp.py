"""The ICP kernels and their plain PyTorch versions (``csrc/icp_nn.cu``).

The nearest-neighbour step of ICP (:func:`icp_correspondences`): for each
source point of a batch of cloud pairs, the closest valid target point; and
the whole point-to-line ICP loop around it, every iteration of every pair
in one launch (:func:`icp_point_to_line_fused`).  The search splits each
source point's scan over a few lanes; the fused point-to-line kernel runs
one block per cloud pair (:func:`icp_fused_layout`).
:func:`icp_rotation_sin_cos` checks the fused kernel's rotation against
``torch.sin``/``torch.cos``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fastslam_tpu_torch.core.cuda_kernels._launch import launch, ptr, require_cuda

# the fused point-to-line ICP kernel: threads per cloud pair and lanes per
# source point, the fastest of seven at both the online (2 pairs) and the
# replay (597 pairs) batch (phase 9, PERF.md §6); then the targets staged
# per shared-memory tile, the eleven sums, and the bytes up to which the
# per-point arrays (sums [11, P2], moved source [N, 2]) stay in shared
# memory, past which they go to device-memory scratch (csrc/icp_nn.cu:
# TGT_TILE, kSums, kPointSmemBytes)
ICP_THREADS, ICP_LANES = 512, 8
ICP_TGT_TILE = 1024
ICP_SUMS = 11
ICP_POINT_SMEM_BYTES = 65536


def icp_correspondences_ref(source, target, target_valid):
    """Plain PyTorch version of :func:`icp_correspondences` (same contract):
    the dense ``[..., N, Mt]`` squared distances, ``inf`` on invalid
    targets, the first index at the minimum and the square root of it."""
    _check_nn_inputs(source, target, target_valid)
    diff = source[..., :, None, :] - target[..., None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(target_valid[..., None, :], d2, torch.inf)
    idx = torch.argmin(d2, dim=-1, keepdim=True)   # first of equal minima
    dist = torch.sqrt(torch.gather(d2, -1, idx))[..., 0]
    return dist, idx[..., 0].to(torch.int32)


def _rotate(x, y, c, s):
    """``R(theta) (x, y)`` elementwise, as ``proposal/icp.py:rotate_points``."""
    return c * x - s * y, s * x + c * y


def icp_point_to_line_ref(source, target, source_valid, target_valid, normals,
                          normal_valid, max_iter: int, tol: float):
    """Plain PyTorch version of :func:`icp_point_to_line_fused` (same
    contract): the batched while-loop of point-to-line ICP, each pair frozen
    once it converges, its sums by :func:`~fastslam_tpu_torch.core.kernels.tree_sum`
    in the kernel's order.  The host checks every iteration whether a pair is
    still active (on the CPU that costs nothing)."""
    from fastslam_tpu_torch.core.kernels import tree_sum

    _check_icp_fused_inputs(source, target, source_valid, target_valid, normals,
                            normal_valid, max_iter)
    b = source.shape[0]
    dev, dt = source.device, source.dtype
    sw = source_valid.to(dt)
    # the normal and its validity gathered together: [B, Mt, 3]
    nq = torch.cat([normals, normal_valid.to(dt)[..., None]], dim=-1)
    gather = lambda pts, idx: torch.gather(
        pts, 1, idx.long()[..., None].expand(*idx.shape, pts.shape[-1]))
    src = source
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    theta_total = torch.zeros(b, dtype=dt, device=dev)
    trans_total = torch.zeros((b, 2), dtype=dt, device=dev)
    prev_err = torch.full((b,), torch.inf, dtype=dt, device=dev)
    converged = torch.zeros(b, dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        if bool(converged.all()):
            break
        active = ~converged
        dist, idx = icp_correspondences_ref(src, target, target_valid)
        q = gather(target, idx)
        ng = gather(nq, idx)
        nx, ny = ng[..., 0], ng[..., 1]
        w = sw * ng[..., 2]
        sx, sy = src[..., 0], src[..., 1]
        r = (sx - q[..., 0]) * nx + (sy - q[..., 1]) * ny
        j0 = sx * ny - sy * nx           # J = [cross(s, n), n_x, n_y]
        wj0, wj1, wj2 = w * j0, w * nx, w * ny
        sums = tree_sum(torch.stack([wj0 * j0, wj0 * nx, wj0 * ny, wj1 * nx, wj1 * ny,
                                     wj2 * ny, wj0 * r, wj1 * r, wj2 * r, dist * w, w],
                                    dim=1))
        h00 = sums[:, 0] + 1e-9
        h01 = sums[:, 1]
        h02 = sums[:, 2]
        h11 = sums[:, 3] + 1e-9
        h12 = sums[:, 4]
        h22 = sums[:, 5] + 1e-9
        b0, b1, b2 = -sums[:, 6], -sums[:, 7], -sums[:, 8]
        # 3x3 symmetric solve via cofactors
        c00 = h11 * h22 - h12 * h12
        c01 = h02 * h12 - h01 * h22
        c02 = h01 * h12 - h02 * h11
        det = h00 * c00 + h01 * c01 + h02 * c02
        det = torch.where(torch.abs(det) > 1e-12, det, 1e-12)
        c11 = h00 * h22 - h02 * h02
        c12 = h01 * h02 - h00 * h12
        c22 = h00 * h11 - h01 * h01
        theta = (c00 * b0 + c01 * b1 + c02 * b2) / det
        tx = (c01 * b0 + c11 * b1 + c12 * b2) / det
        ty = (c02 * b0 + c12 * b1 + c22 * b2) / det
        err = sums[:, 9] / torch.clamp_min(sums[:, 10], 1e-12)

        c, s = torch.cos(theta), torch.sin(theta)
        x, y = _rotate(sx, sy, c[:, None], s[:, None])
        new_src = torch.stack([x + tx[:, None], y + ty[:, None]], dim=-1)
        x, y = _rotate(trans_total[:, 0], trans_total[:, 1], c, s)
        new_trans_total = torch.stack([x + tx, y + ty], dim=-1)
        src = torch.where(active[:, None, None], new_src, src)
        trans_total = torch.where(active[:, None], new_trans_total, trans_total)
        theta_total = torch.where(active, theta_total + theta, theta_total)
        conv = torch.abs(prev_err - err) < tol
        prev_err = torch.where(active, err, prev_err)
        converged = torch.where(active, conv, converged)
        it = it + active.to(torch.int32)
    return theta_total, trans_total, prev_err, it


def icp_rotation_sin_cos_ref(x):
    """Plain PyTorch version of :func:`icp_rotation_sin_cos`."""
    _check_sin_cos(x)
    return torch.sin(x), torch.cos(x)


def _check_nn_inputs(source, target, target_valid):
    if source.dim() not in (2, 3) or source.shape[-1] != 2:
        raise ValueError(f"source must be [N, 2] or [B, N, 2], got {tuple(source.shape)}")
    batch = tuple(source.shape[:-2])
    if target.dim() != source.dim() or target.shape[-1] != 2 \
            or tuple(target.shape[:-2]) != batch:
        raise ValueError(f"target must be [{', '.join(map(str, batch + ('Mt', 2)))}], "
                         f"got {tuple(target.shape)}")
    if tuple(target_valid.shape) != tuple(target.shape[:-1]) \
            or target_valid.dtype != torch.bool:
        raise ValueError("target_valid must be bool of the target's leading shape")
    device = source.device
    for t in (source, target):
        if t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"source and target must be float32 on {device}, "
                             f"got {t.dtype} on {t.device}")
    if target_valid.device != device:
        raise ValueError(f"target_valid must lie on {device}")


def _check_icp_fused_inputs(source, target, source_valid, target_valid, normals,
                            normal_valid, max_iter):
    if source.dim() != 3 or source.shape[-1] != 2 or source.shape[1] < 1:
        raise ValueError(f"source must be [B, N, 2] with N >= 1, got {tuple(source.shape)}")
    b, n = source.shape[:2]
    if target.dim() != 3 or target.shape[0] != b or target.shape[-1] != 2 \
            or target.shape[1] < 1:
        raise ValueError(f"target must be [{b}, Mt, 2] with Mt >= 1, got "
                         f"{tuple(target.shape)}")
    mt = target.shape[1]
    device = source.device
    for name, t, shape, dtype in (
            ("target", target, (b, mt, 2), torch.float32),
            ("normals", normals, (b, mt, 2), torch.float32),
            ("source_valid", source_valid, (b, n), torch.bool),
            ("target_valid", target_valid, (b, mt), torch.bool),
            ("normal_valid", normal_valid, (b, mt), torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
            raise ValueError(f"{name} must be {dtype} {shape} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if source.dtype != torch.float32:
        raise ValueError(f"source must be float32, got {source.dtype}")
    if int(max_iter) < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")


def _check_sin_cos(x):
    if x.dtype != torch.float32 or x.dim() != 1 or x.numel() >= 2 ** 31:
        raise ValueError(f"the rotation check takes a float32 vector of fewer than 2^31 "
                         f"values, got {x.dtype} {tuple(x.shape)}")


def icp_fused_layout(n: int, mt: int) -> Tuple[int, int, bool]:
    """``(p2, smem, in_scratch)`` of the fused point-to-line kernel for N
    source and Mt target points: the least power of two ``p2 >= N`` that the
    sums' tree pads the point axis to, the block's dynamic shared memory (a
    tile of up to ``ICP_TGT_TILE`` targets with normals and flags, 20 bytes
    each, and the per-point arrays unless they go to scratch), and whether
    the per-point arrays (``[11, p2]`` terms and the ``[N, 2]`` moved
    source) go to a device-memory scratch row of each pair
    (``csrc/icp_nn.cu``: ``icp_fused_shared_bytes``)."""
    p2 = 1 << max(n - 1, 0).bit_length()
    points = 4 * (ICP_SUMS * p2 + 2 * n)
    in_scratch = points > ICP_POINT_SMEM_BYTES
    return p2, 20 * min(mt, ICP_TGT_TILE) + (0 if in_scratch else points), in_scratch


def icp_correspondences(source, target, target_valid):
    """Nearest valid target point of every source point (ICP correspondences).

    Args:
      source ``[N, 2]`` or ``[B, N, 2]`` float32; target ``[Mt, 2]`` or
      ``[B, Mt, 2]`` float32; target_valid ``[Mt]`` or ``[B, Mt]`` bool.  With
      a leading batch axis each source cloud is matched against the target
      cloud of the same pair.

    Returns ``(dist, idx)``, each ``[N]`` or ``[B, N]``: the Euclidean
    distance (float32) and index (int32) of the closest valid target; the
    first index on ties; ``(inf, 0)`` when no target is valid.
    """
    if source.device.type == "cpu":
        return icp_correspondences_ref(source, target, target_valid)
    _check_nn_inputs(source, target, target_valid)
    device = require_cuda(source, target, target_valid)
    n, mt = source.shape[-2], target.shape[-2]
    b = source.shape[0] if source.dim() == 3 else 1
    batch = tuple(source.shape[:-2])
    dist = torch.empty(batch + (n,), dtype=torch.float32, device=device)
    idx = torch.empty(batch + (n,), dtype=torch.int32, device=device)
    launch(
        "icp_correspondences", device,
        ptr(source), ptr(target), ptr(target_valid), ptr(dist), ptr(idx),
        ctypes.c_int(b), ctypes.c_int(n), ctypes.c_int(mt),
    )
    return dist, idx


def icp_point_to_line_fused(source, target, source_valid, target_valid, normals,
                            normal_valid, max_iter: int, tol: float):
    """Point-to-line ICP for a batch of cloud pairs, every iteration of every
    pair in one launch: the while-loop of ``proposal/icp.py``, each pair
    stopping at ``|prev_err - err| < tol`` or after ``max_iter`` iterations,
    decided on the device.

    Args:
      source ``[B, N, 2]``, target ``[B, Mt, 2]`` float32; source_valid
      ``[B, N]``, target_valid ``[B, Mt]`` bool; normals ``[B, Mt, 2]``
      float32 and normal_valid ``[B, Mt]`` bool, the target's normals
      (``proposal/icp.py:estimate_normals``); N, Mt >= 1.

    Returns ``(theta [B], translation [B, 2], mean_error [B], num_iters [B]
    int32)``: the accumulated rotation angle and translation, the last
    iteration's mean NN distance (inf after no iteration), the iterations
    each pair ran.
    """
    if source.device.type == "cpu":
        return icp_point_to_line_ref(source, target, source_valid, target_valid, normals,
                                     normal_valid, max_iter, tol)
    _check_icp_fused_inputs(source, target, source_valid, target_valid, normals,
                            normal_valid, max_iter)
    device = require_cuda(source, target, source_valid, target_valid, normals, normal_valid)
    b, n = source.shape[:2]
    mt = target.shape[1]
    if b >= 2 ** 31:
        raise ValueError(f"one launch takes fewer than 2^31 cloud pairs, got {b}")
    p2, _, in_scratch = icp_fused_layout(n, mt)
    scratch = (torch.empty((b, ICP_SUMS * p2 + 2 * n), dtype=torch.float32, device=device)
               if in_scratch else None)
    theta = torch.empty(b, dtype=torch.float32, device=device)
    trans = torch.empty((b, 2), dtype=torch.float32, device=device)
    err = torch.empty(b, dtype=torch.float32, device=device)
    iters = torch.empty(b, dtype=torch.int32, device=device)
    launch(
        "icp_point_to_line", device,
        ptr(source), ptr(target), ptr(source_valid), ptr(target_valid), ptr(normals),
        ptr(normal_valid), ptr(scratch), ptr(theta), ptr(trans), ptr(err),
        ptr(iters), ctypes.c_int(b), ctypes.c_int(n), ctypes.c_int(mt), ctypes.c_int(p2),
        ctypes.c_int(int(max_iter)), ctypes.c_float(tol), ctypes.c_int(ICP_THREADS),
        ctypes.c_int(ICP_LANES),
    )
    return theta, trans, err, iters


def icp_rotation_sin_cos(x):
    """``(sin x, cos x)`` of a float32 vector as the fused ICP kernel rotates
    by them (``csrc/icp_nn.cu``: ``rotation_sin_cos``), in one launch: the
    check that they equal ``torch.sin``/``torch.cos`` on the card."""
    if x.device.type == "cpu":
        return icp_rotation_sin_cos_ref(x)
    _check_sin_cos(x)
    device = require_cuda(x)
    s, c = torch.empty_like(x), torch.empty_like(x)
    launch("icp_sin_cos", device, ptr(x), ptr(s), ptr(c),
           ctypes.c_int(x.numel()))
    return s, c
