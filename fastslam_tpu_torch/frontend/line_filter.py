"""Scan smoothing: a Gaussian filter along the beam axis.

Counterpart of ``fastslam_tpu/frontend/line_filter.py``.  scipy's radius
formula ``int(truncate * sigma + 0.5)`` gives radius 0 for the default sigma
of 0.1, so the default filter is the identity; the general case is a
reflect-padded 1-D correlation, kept in float32 (the caller turns TF32 off).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fastslam_tpu_torch.config import FastSLAMConfig


def _gaussian_kernel(sigma: float, truncate: float) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)  # scipy's formula
    if radius <= 0:
        return np.ones((1,), np.float32)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _kernel_on(sigma: float, truncate: float, device: torch.device) -> torch.Tensor:
    """The Gaussian kernel on ``device``, copied there once (a copy from the
    host inside a CUDA graph capture would fail)."""
    return torch.from_numpy(_gaussian_kernel(sigma, truncate)).to(device)


def line_filter(points: torch.Tensor, config: FastSLAMConfig) -> torch.Tensor:
    """Smooth ``[N, 2]`` scan points along the beam axis (reflect boundary)."""
    kernel = _gaussian_kernel(config.line_filter_sigma, config.line_filter_truncate)
    if kernel.shape[0] == 1:
        return points
    r = kernel.shape[0] // 2
    # reflect padding as scipy mode='reflect' ((d c b a | a b c d | d c b a))
    padded = torch.cat([points[:r].flip(0), points, points[-r:].flip(0)], dim=0)
    k = _kernel_on(config.line_filter_sigma, config.line_filter_truncate, points.device)
    n = points.shape[0]
    idx = (torch.arange(n, device=points.device)[:, None]
           + torch.arange(kernel.shape[0], device=points.device)[None, :])
    return torch.einsum("nkc,k->nc", padded[idx], k)
