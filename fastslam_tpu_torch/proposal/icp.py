"""2-D ICP with masked fixed-size clouds, batched over cloud pairs.

Counterpart of ``fastslam_tpu/proposal/icp.py``.  Every function takes an
optional leading batch axis of cloud pairs: ``[N, 2]`` clouds, or
``[B, N, 2]`` with one source/target pair per batch entry.

* Nearest neighbours are the dense all-pairs search with a first-index
  argmin; on CUDA tensors :func:`nearest_neighbors` launches the
  hand-written kernel (``core/cuda_kernels.py:icp_correspondences``), on CPU
  tensors it runs that kernel's plain version.
* The best-fit rotation is the closed-form 2-D solution (an angle, never an
  SVD); point-to-line ICP solves its 3x3 normal equations by cofactors, with
  the ``|det| > 1e-12`` clamp of the reference.
* Point-to-line ICP (:func:`icp_point_to_line`, the proposal's scan match)
  runs its whole while-loop in one call of
  ``core/cuda_kernels.py:icp_point_to_line_fused``: on CUDA tensors one
  kernel launch per call, each pair converging on the device; on CPU
  tensors the kernel's plain version.  Its sums add in one fixed tree order
  (``core/kernels.py:tree_sum``).
* Point-to-point :func:`icp` turns the JAX ``lax.while_loop`` into a loop of
  ``max_iter`` iterations over the batch with a per-pair ``active =
  ~converged`` mask: a converged pair keeps its carry (``torch.where``), so
  each pair ends exactly where its own while-loop would.  The first
  iteration starts from ``prev_err = err = inf``, so ``|inf - err| = inf``
  never reads as converged.  The host stops early once no pair is active,
  checking every ``_CHECK_EVERY`` iterations (each check is a device-to-host
  sync).

Numerics note kept from the reference: rotations are carried as angles and
applied elementwise (``x' = c x - s y``), never as ``points @ R.T`` matmuls;
normals come from central differences along the scan order (``roll``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels

# host early-exit check period of the batched loops
_CHECK_EVERY = 2


class ICPResult(NamedTuple):
    rotation: torch.Tensor      # [..., 2, 2] accumulated rotation matrix
    translation: torch.Tensor   # [..., 2] accumulated translation
    mean_error: torch.Tensor    # [...] final mean NN distance
    num_iters: torch.Tensor     # [...] int32 iterations executed
    theta: torch.Tensor         # [...] accumulated rotation angle (exact)


def rotate_points(points: torch.Tensor, theta) -> torch.Tensor:
    """Apply R(theta) to ``[..., 2]`` points elementwise; ``theta`` is a
    scalar or broadcasts against ``points[..., 0]``."""
    theta = torch.as_tensor(theta, dtype=points.dtype, device=points.device)
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = points[..., 0], points[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def nearest_neighbors(source: torch.Tensor, target: torch.Tensor,
                      target_valid: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each source point the closest valid target point.

    Returns ``(distances [..., N], indices [..., N] int32)``."""
    return cuda_kernels.icp_correspondences(source, target, target_valid)


def best_fit_angle(source: torch.Tensor, target: torch.Tensor,
                   weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted closed-form 2-D rigid alignment source -> target, as an
    angle: theta* = atan2(sum w (s x t), sum w (s . t)) over centered pairs;
    translation = t_centroid - R s_centroid."""
    wsum = torch.clamp_min(torch.sum(weight, dim=-1), 1e-12)[..., None]
    cs = torch.sum(source * weight[..., None], dim=-2) / wsum
    ct = torch.sum(target * weight[..., None], dim=-2) / wsum
    s = source - cs[..., None, :]
    t = target - ct[..., None, :]
    dot = torch.sum(weight * (s[..., 0] * t[..., 0] + s[..., 1] * t[..., 1]), dim=-1)
    cross = torch.sum(weight * (s[..., 0] * t[..., 1] - s[..., 1] * t[..., 0]), dim=-1)
    theta = torch.atan2(cross, dot)
    trans = ct - rotate_points(cs, theta)
    return theta, trans


def rotation_matrix(theta: torch.Tensor) -> torch.Tensor:
    c, sn = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -sn], dim=-1),
                        torch.stack([sn, c], dim=-1)], dim=-2)


def best_fit_transform(source: torch.Tensor, target: torch.Tensor,
                       weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`best_fit_angle` with the rotation as a ``[..., 2, 2]`` matrix."""
    theta, trans = best_fit_angle(source, target, weight)
    return rotation_matrix(theta), trans


def _gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points[idx]`` per pair: ``[B, M, k]`` gathered by ``[B, N]``."""
    index = idx.long()[..., None].expand(*idx.shape, points.shape[-1])
    return torch.gather(points, -2, index)


def _iterate(body, source: torch.Tensor, max_iter: int, tol: float) -> ICPResult:
    """The batched while-loop of point-to-point ICP over ``[B, N, 2]``.

    ``body(src) -> (theta, trans [B, 2], err)`` is one iteration for every
    pair; pairs that have converged keep their carry."""
    b = source.shape[0]
    dev, dt = source.device, source.dtype
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    src = source
    theta_total = torch.zeros(b, dtype=dt, device=dev)
    trans_total = torch.zeros((b, 2), dtype=dt, device=dev)
    prev_err = torch.full((b,), torch.inf, dtype=dt, device=dev)
    converged = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(max_iter):
        if i % _CHECK_EVERY == 0 and i and bool(converged.all()):
            break
        active = ~converged   # it < max_iter holds for every pair inside the loop
        theta, trans, err = body(src)
        new_src = rotate_points(src, theta[:, None]) + trans[:, None, :]
        new_trans_total = rotate_points(trans_total, theta) + trans
        src = torch.where(active[:, None, None], new_src, src)
        trans_total = torch.where(active[:, None], new_trans_total, trans_total)
        theta_total = torch.where(active, theta_total + theta, theta_total)
        conv = torch.abs(prev_err - err) < tol
        prev_err = torch.where(active, err, prev_err)
        converged = torch.where(active, conv, converged)
        it = it + active.to(torch.int32)
    return ICPResult(rotation=rotation_matrix(theta_total), translation=trans_total,
                     mean_error=prev_err, num_iters=it, theta=theta_total)


def _batched(fn, source, target, source_valid, target_valid, config):
    """Run ``fn`` on ``[B, ...]`` inputs; an unbatched call gets a batch of one."""
    if source.dim() == 2:
        res = fn(source[None], target[None], source_valid[None], target_valid[None],
                 config)
        return ICPResult(*(x[0] for x in res))
    return fn(source, target, source_valid, target_valid, config)


def _icp(source, target, source_valid, target_valid, config):
    sw = source_valid.to(source.dtype)
    target = target.contiguous()
    target_valid = target_valid.contiguous()

    def body(src):
        dist, idx = nearest_neighbors(src, target, target_valid)
        matched = _gather_points(target, idx)
        theta, trans = best_fit_angle(src, matched, sw)
        err = torch.sum(dist * sw, dim=-1) / torch.clamp_min(torch.sum(sw, dim=-1), 1e-12)
        return theta, trans, err

    return _iterate(body, source.contiguous(), config.icp_max_iterations,
                    config.icp_tolerance)


def icp(source: torch.Tensor, target: torch.Tensor, source_valid: torch.Tensor,
        target_valid: torch.Tensor, config: FastSLAMConfig) -> ICPResult:
    """Point-to-point ICP between masked clouds: NN correspondence, best-fit
    transform, apply to the source, accumulate (theta_total += theta,
    t_total = R(theta) t_total + t), until |prev_err - err| < tolerance."""
    return _batched(_icp, source, target, source_valid, target_valid, config)


def estimate_normals(points: torch.Tensor, valid: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point unit normals from the central-difference tangent along the
    scan order; a point with an invalid neighbour gets an invalid normal."""
    nxt = torch.roll(points, -1, dims=-2)
    prv = torch.roll(points, 1, dims=-2)
    tangent = nxt - prv
    norm = torch.sqrt(torch.sum(tangent * tangent, dim=-1, keepdim=True))
    ok = (valid & torch.roll(valid, -1, dims=-1) & torch.roll(valid, 1, dims=-1)
          & (norm[..., 0] > 1e-9))
    t_unit = tangent / torch.clamp_min(norm, 1e-9)
    normals = torch.stack([-t_unit[..., 1], t_unit[..., 0]], dim=-1)
    return normals, ok


def _icp_point_to_line(source, target, source_valid, target_valid, config):
    target = target.contiguous()
    target_valid = target_valid.contiguous()
    normals, n_ok = estimate_normals(target, target_valid)
    theta, trans, err, iters = cuda_kernels.icp_point_to_line_fused(
        source.contiguous(), target, source_valid.contiguous(), target_valid,
        normals.contiguous(), n_ok.contiguous(), config.icp_max_iterations,
        config.icp_tolerance)
    return ICPResult(rotation=rotation_matrix(theta), translation=trans, mean_error=err,
                     num_iters=iters, theta=theta)


def icp_point_to_line(source: torch.Tensor, target: torch.Tensor,
                      source_valid: torch.Tensor, target_valid: torch.Tensor,
                      config: FastSLAMConfig) -> ICPResult:
    """Point-to-line ICP: minimize ``(R s + t - q) . n_q`` over the target's
    local lines, one small-angle 3x3 normal-equation solve in
    (theta, tx, ty) per iteration.  Removes point-to-point ICP's bias
    toward zero motion along walls.  The whole loop is one call of
    ``cuda_kernels.icp_point_to_line_fused`` (one launch on the card)."""
    return _batched(_icp_point_to_line, source, target, source_valid, target_valid,
                    config)


def icp_odometry(result: ICPResult, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rotation, translation) odometry from an ICP result: while
    translating |t| and zero rotation, while rotating -theta and zero
    translation (``robot.py:90-120``)."""
    moving = torch.as_tensor(v, device=result.theta.device) != 0
    translation = torch.where(moving, torch.linalg.vector_norm(result.translation, dim=-1),
                              0.0)
    rotation = torch.where(moving, 0.0, -result.theta)
    return rotation, translation
