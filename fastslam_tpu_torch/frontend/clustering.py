"""Density clustering (DBSCAN) on fixed-capacity tensors.

Counterpart of ``fastslam_tpu/frontend/clustering.py``: a dense
eps-adjacency matrix and iterated min-label propagation with pointer
jumping, then masked centroids.  :func:`connected_component_clusters` is
DBSCAN with ``min_samples=1`` (the frontend's intersection clustering);
:func:`dbscan_clusters` is full DBSCAN with core, border and noise points
(the global landmark map's merge).  The output is a per-point cluster
representative and centroid at static shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Clusters(NamedTuple):
    centroid: torch.Tensor  # [N, 2] centroid of the cluster containing point i
    is_rep: torch.Tensor    # [N] bool, True on exactly one member per cluster
    label: torch.Tensor     # [N] int64 root index of the cluster (min member idx)


def _propagate_min_labels(adj: torch.Tensor, valid: torch.Tensor,
                          iters: int) -> torch.Tensor:
    """Min-label propagation over a boolean adjacency matrix ``[N, N]``, with
    pointer jumping (``labels[labels]``) so ~log2(N) iterations converge."""
    n = adj.shape[0]
    idx = torch.arange(n, device=adj.device)
    labels = torch.where(valid, idx, n)
    for _ in range(iters):
        neigh = torch.where(adj, labels[None, :], n)
        labels = torch.minimum(labels, neigh.amin(dim=1))
        # invalid points carry the sentinel label n, one past the end: JAX
        # clamps that gather index to n-1, torch raises, so clamp explicitly
        jumped = labels[labels.clamp(max=n - 1)]
        labels = torch.where(valid, torch.minimum(labels, jumped), n)
    return labels


def connected_component_clusters(points: torch.Tensor, valid: torch.Tensor,
                                 eps: float, iters: int = 16) -> Clusters:
    """Connected components of the eps-graph of ``[N, 2]`` points."""
    diff = points[:, None, :] - points[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    adj = (d2 <= eps * eps) & valid[:, None] & valid[None, :]
    labels = _propagate_min_labels(adj, valid, iters)
    return _centroids(points, valid, labels)


def dbscan_clusters(points: torch.Tensor, valid: torch.Tensor, eps: float,
                    min_samples, iters: int = 16) -> Clusters:
    """Full DBSCAN of ``[N, 2]`` points; ``min_samples`` may be a 0-d
    tensor (computed on the device, never read on the host).

    A point is core if its eps-ball (itself included) holds at least
    ``min_samples`` valid points; clusters are the connected components of
    the core points; a non-core point joins the smallest label among its
    core neighbours (a border point); the rest is noise (``is_rep`` False,
    label ``N``)."""
    n = points.shape[0]
    diff = points[:, None, :] - points[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    adj = (d2 <= eps * eps) & valid[:, None] & valid[None, :]
    degree = adj.sum(dim=1)   # includes the point itself
    core = valid & (degree >= min_samples)
    labels = _propagate_min_labels(adj & core[:, None] & core[None, :], core, iters)
    border = torch.where(adj & core[None, :], labels[None, :], n).amin(dim=1)
    labels = torch.where(core, labels, border)
    return _centroids(points, labels < n, labels)


def _centroids(points: torch.Tensor, valid: torch.Tensor,
               labels: torch.Tensor) -> Clusters:
    """Per-cluster sums over a dense ``[N, N]`` membership mask, reduced with
    ``sum(dim=1)``: a fixed summation order, so the card gives the same
    centroids on every run (a float ``index_add_`` adds with atomics there,
    in an order that changes from run to run)."""
    n = points.shape[0]
    safe = torch.where(valid, labels, n - 1)
    idx = torch.arange(n, device=points.device)
    member = (safe[None, :] == idx[:, None]) & valid[None, :]   # [cluster, point]
    count = member.sum(dim=1).to(points.dtype)                  # exact
    sx = torch.where(member, points[None, :, 0], 0.0).sum(dim=1)
    sy = torch.where(member, points[None, :, 1], 0.0).sum(dim=1)
    denom = torch.clamp_min(count, 1.0)
    cx = (sx / denom)[safe]
    cy = (sy / denom)[safe]
    return Clusters(
        centroid=torch.stack([cx, cy], dim=-1),
        is_rep=valid & (labels == idx),
        label=torch.where(valid, labels, n),
    )
