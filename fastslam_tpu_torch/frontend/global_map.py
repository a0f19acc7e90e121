"""The global landmark map for visualization: a DBSCAN merge across
particles.

Counterpart of ``fastslam_tpu/frontend/global_map.py``.  The reference
clusters every particle's landmarks with DBSCAN (eps 0.5, ``min_samples`` =
0.7 x the average landmarks per particle) each tick; here a subsample of the
particles is clustered densely on the device, so the ``[N, N]`` adjacency
stays bounded at 100,000 particles.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core.state import FilterState
from fastslam_tpu_torch.frontend.clustering import dbscan_clusters


def cluster_known_landmarks(state: FilterState, config: FastSLAMConfig,
                            max_particles: int = 32
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster the landmarks of every ``P // n``-th particle (``n =
    min(P, max_particles)``) of a blocks-layout state into a global map.

    Returns ``(centroids [K, 2], valid [K])``, ``K = n * L``.
    ``min_samples`` is ``floor(0.7 * avg)`` of the average landmarks per
    sampled particle, in float32 on the device; with ``min_samples < 1`` no
    centroid is valid, as in the reference.
    """
    p = state.num_particles
    n_sample = min(p, max_particles)
    stride = max(p // n_sample, 1)
    sel = torch.arange(n_sample, device=state.device) * stride
    mean = state.lm_mean[sel].reshape(-1, 2)
    valid = state.lm_valid_mask()[sel].reshape(-1)
    avg = valid.sum() / n_sample                            # float32
    min_samples = torch.floor(avg * config.viz_min_samples_frac).to(torch.int32)
    cl = dbscan_clusters(mean, valid, config.viz_cluster_eps, min_samples)
    return cl.centroid, cl.is_rep & (min_samples >= 1)
