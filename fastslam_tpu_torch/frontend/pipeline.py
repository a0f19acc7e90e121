"""Scan -> measurements: the perception frontend.

Counterpart of ``fastslam_tpu/frontend/pipeline.py``: scan points -> line
filter -> Hough line intersections -> eps=0.5 connected-component clustering
-> corner gate (an intersection is a corner iff a scan point lies within
0.1 m) -> (range, bearing) measurements from the origin.  The final
compaction into ``[max_measurements]`` is a stable sort, so measurement order
follows intersection order.
"""

from __future__ import annotations

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core.state import Measurements
from fastslam_tpu_torch.frontend.clustering import connected_component_clusters
from fastslam_tpu_torch.frontend.hough import hough_lines, line_intersections
from fastslam_tpu_torch.frontend.line_filter import line_filter


def extract_corners(points: torch.Tensor, valid: torch.Tensor,
                    config: FastSLAMConfig):
    """Corner landmarks of a ``[N, 2]`` scan (robot frame).

    Returns ``(corners [C, 2], corner_valid [C])``, ``C = max_hough_lines**2``.
    """
    filtered = line_filter(points, config)
    lines, off_x, off_y, width, height = hough_lines(filtered, valid, config)
    inter = line_intersections(lines, off_x, off_y, width, height, config)
    clusters = connected_component_clusters(inter.xy, inter.valid, config.cluster_eps)

    # corner gate: cluster centroid within corner_threshold of a scan point
    diff = clusters.centroid[:, None, :] - filtered[None, :, :]     # [C, N, 2]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(valid[None, :], d2, torch.inf)
    near_scan = d2.amin(dim=1) <= config.corner_threshold ** 2
    return clusters.centroid, clusters.is_rep & near_scan


def measurements_from_corners(corners: torch.Tensor, corner_valid: torch.Tensor,
                              config: FastSLAMConfig) -> Measurements:
    """(x, y) corners -> padded (range, bearing) measurements from the origin."""
    dist = torch.sqrt(torch.sum(corners * corners, dim=-1))
    bearing = torch.atan2(corners[:, 1], corners[:, 0])
    # stable compaction: valid entries first, original order preserved
    order = torch.sort((~corner_valid).to(torch.int32), stable=True).indices
    take = order[:config.max_measurements]
    rb = torch.stack([dist[take], bearing[take]], dim=-1)
    return Measurements(range_bearing=rb, valid=corner_valid[take])


def scan_to_measurements(points: torch.Tensor, valid: torch.Tensor,
                         config: FastSLAMConfig) -> Measurements:
    """The full frontend: ``[N, 2]`` scan -> padded measurement batch."""
    corners, corner_valid = extract_corners(points, valid, config)
    return measurements_from_corners(corners, corner_valid, config)
