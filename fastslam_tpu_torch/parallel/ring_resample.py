"""The distributed resampler over the ring halo exchange kernel.

Counterpart of ``fastslam_tpu/parallel/ring_resample.py``.  Each shard's
state is packed into one ``[P_local, D]`` float32 block; one launch of the
exchange kernel (``core/cuda_kernels.py:ring_halo_exchange``,
``csrc/ring_halo.cu``) gives every shard its left and right neighbours'
blocks; then each shard gathers its systematic-resampling ancestors from the
three-block window, or from the whole state when some window does not fit,
with the ancestor-window math of ``parallel/resample.py``.  On CPU shards the
wrapper runs the kernel's plain version.

The TPU kernel moves the blocks between chips with remote DMAs behind a
neighbour barrier; here the shards share one card and stream order stands in
for the barrier.  The cross-card form is queued (ROADMAP §1).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.core.state import FilterState
from fastslam_tpu_torch.parallel.collectives import all_gather, ppermute
from fastslam_tpu_torch.parallel.mesh import ParticleMesh
from fastslam_tpu_torch.parallel.resample import (
    pack_particle_block, shard_ancestor_window, uniform_log_weights,
    unpack_particle_block,
)


def _kernel_exchange(blocks, devices):
    """Both halos of every shard in one launch of the exchange kernel."""
    return cuda_kernels.ring_halo_exchange(blocks)


def _ppermute_exchange(blocks, devices):
    """The plain exchange with the kernel's ``(lefts, rights)`` contract: two
    ring shifts of the collectives module."""
    return ppermute(blocks, 1, devices), ppermute(blocks, -1, devices)


def _ring_body(shards: Sequence[FilterState], u0: torch.Tensor, mesh: ParticleMesh,
               parity: bool, exchange=None) -> List[FilterState]:
    """Pack, exchange, gather from the window (or the whole state), unpack."""
    p_local, l = shards[0].num_particles, shards[0].max_landmarks
    p = p_local * len(shards)
    idx, safe_local, use_halo = shard_ancestor_window(
        [s.log_weights for s in shards], u0)
    blocks = [pack_particle_block(s.poses, s.log_weights, s.lm_mean, s.lm_cov,
                                  s.lm_count) for s in shards]
    lefts, rights = (exchange or _kernel_exchange)(blocks, mesh.devices)
    if use_halo:
        new = [torch.cat([lefts[k], blocks[k], rights[k]]).index_select(0, safe_local[k])
               for k in range(len(shards))]
    else:
        full = all_gather(blocks)
        new = [full.index_select(0, idx[k].to(full.device)).to(dev)
               for k, dev in enumerate(mesh.devices)]
    out = []
    for block in new:
        poses, logw, mean, cov, count = unpack_particle_block(block, l)
        if not parity:
            logw = uniform_log_weights(logw, p)
        out.append(FilterState(poses=poses.contiguous(), log_weights=logw.contiguous(),
                               lm_mean=mean.contiguous(), lm_cov=cov.contiguous(),
                               lm_count=count))
    return out


def ring_halo_resample(shards: Sequence[FilterState], u0: torch.Tensor,
                       mesh: ParticleMesh, config: FastSLAMConfig, *,
                       _exchange=None) -> List[FilterState]:
    """Drop-in for ``resample.halo_systematic_resample`` built on the exchange
    kernel: one launch per call, on the halo path and the fallback alike.
    ``_exchange`` (testing) swaps the kernel for :func:`_ppermute_exchange`
    or another function of ``(blocks, devices) -> (lefts, rights)``."""
    return _ring_body(shards, u0, mesh, config.parity_mode, exchange=_exchange)
