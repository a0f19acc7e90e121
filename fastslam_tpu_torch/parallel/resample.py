"""Distributed systematic resampling with one-block halos.

Counterpart of ``fastslam_tpu/parallel/resample.py``.  Systematic resampling
draws non-decreasing ancestor indices, so each shard's ancestors form a
contiguous window of the global particle array; with healthy weights that
window lies within the shard's own block and one neighbour block on each
side.  So: gather the weights only, compute each shard's global ancestor
indices, exchange one-block halos with the ring neighbours, and gather
locally from the three-block window, or, when some shard's window does not
fit (weight collapsed onto a far shard), gather from the whole state.

The ancestor indices are the port's single-device staircase over the
gathered weights (``core/kernels.py:systematic_resample_indices``, with its
fixed-order cumulative sum), sliced to each shard, so both paths are
bit-identical to ``resample_state`` with the same ``u0`` by construction.
The halo-or-fallback choice is one integer :func:`psum`, read once on the
host.

Across a process group the weights are gathered over the group, the halos
cross the process boundary through :func:`ppermute`'s point-to-point form,
and the fallback gathers the whole state over the group, each process
keeping its own shards.  On a 2-D mesh every map column (one slot block of
every particle row) is resampled as a ring of its own: the ancestors depend
on the weights only, so each slot block moves with its particles.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import FilterState
from fastslam_tpu_torch.parallel.collectives import (
    all_gather, ppermute, psum, shard_range, site,
)
from fastslam_tpu_torch.parallel.mesh import ParticleMesh, columns, from_columns

_FIELDS = ("poses", "log_weights", "lm_mean", "lm_cov", "lm_count")


def shard_ancestor_window(log_weights: Sequence[torch.Tensor], u0: torch.Tensor,
                          group=None
                          ) -> Tuple[List[torch.Tensor], List[torch.Tensor], bool]:
    """The ancestor-window math shared by the halo resampler and the ring
    resampler (``parallel/ring_resample.py``).

    Args:
      log_weights: each shard's ``[P_local]`` log-weights, in shard order
        (this process's shards of a ring over ``group``).
      u0: the resample offset in ``[0, 1/P)``.
      group: the process group the ring spans, or None.

    Returns ``(idx, safe_local, use_halo)``: per shard its ``[P_local]``
    global ancestor indices (for the fallback gather) and their positions in
    the ``[3 P_local]`` window (left | own | right), clipped; and whether
    every shard's window fits (the same answer for all shards and
    processes).
    """
    p_local = log_weights[0].shape[0]
    first = 0 if group is None else dist.get_rank(group) * len(log_weights)
    weights = all_gather([torch.exp(lw) for lw in log_weights], group=group)   # [P]
    idx_all = kernels.systematic_resample_indices(weights, u0)
    idx, safe_local, outside = [], [], []
    for k, lw in enumerate(log_weights):
        r = shard_range(first + k, p_local)
        i = idx_all[r].to(lw.device)
        local = i - (r.start - p_local)
        # a wrapped neighbour is never indexed: global indices lie in [0, P),
        # so shard 0 never reaches into its left halo, the last shard never
        # into its right one
        outside.append((~((local >= 0) & (local < 3 * p_local)).all()).to(torch.int32))
        idx.append(i)
        safe_local.append(torch.clamp(local, 0, 3 * p_local - 1))
    use_halo = int(psum(outside, group)) == 0
    return idx, safe_local, use_halo


def pack_particle_block(poses, log_weights, lm_mean, lm_cov, lm_count) -> torch.Tensor:
    """A shard's state -> one ``[P_local, D]`` float32 block (poses | logw |
    lm_mean | lm_cov | lm_count), ``D = 3 + 1 + 2L + 4L + 1``.  ``lm_count
    <= L`` is exact in float32.  The block is a new contiguous tensor."""
    p = poses.shape[0]
    return torch.cat([poses, log_weights[:, None], lm_mean.reshape(p, -1),
                      lm_cov.reshape(p, -1), lm_count.to(torch.float32)[:, None]], dim=1)


def unpack_particle_block(block: torch.Tensor, l: int):
    """Inverse of :func:`pack_particle_block`:
    ``(poses, log_weights, lm_mean [P, L, 2], lm_cov [P, L, 4], lm_count)``."""
    p = block.shape[0]
    return (block[:, :3], block[:, 3], block[:, 4: 4 + 2 * l].reshape(p, l, 2),
            block[:, 4 + 2 * l: 4 + 6 * l].reshape(p, l, 4),
            block[:, 4 + 6 * l].to(torch.int32))


def uniform_log_weights(like: torch.Tensor, num_particles: int) -> torch.Tensor:
    """The production log-weights after a resample: ``-log(P)``, as
    ``kernels.resample_state`` sets them."""
    return torch.full_like(like, -math.log(num_particles))


def halo_systematic_resample(shards: Sequence[FilterState], u0: torch.Tensor,
                             mesh: ParticleMesh, config: FastSLAMConfig) -> List[FilterState]:
    """Resample the sharded state; the same result, shard by shard, as
    ``resample_state(state, systematic_resample_indices(...), config)`` on
    the gathered state.  The halos move field by field with :func:`ppermute`;
    a 2-D mesh resamples map column by map column."""
    cols = columns(shards, mesh)
    devices = columns(mesh.devices, mesh)
    p = mesh.particle_shards * shards[0].num_particles
    with site("halo"):
        out = [_halo_ring(col, u0, devs, mesh.group, p, config)
               for col, devs in zip(cols, devices)]
    return from_columns(out, mesh)


def _halo_ring(shards: Sequence[FilterState], u0: torch.Tensor, devices, group, p: int,
               config: FastSLAMConfig) -> List[FilterState]:
    """:func:`halo_systematic_resample` on one ring of shards."""
    idx, safe_local, use_halo = shard_ancestor_window(
        [s.log_weights for s in shards], u0, group)
    out = [{} for _ in shards]
    for name in _FIELDS:
        own = [getattr(s, name) for s in shards]
        if use_halo:
            left = ppermute(own, 1, devices, group)
            right = ppermute(own, -1, devices, group)
            for k in range(len(shards)):
                window = torch.cat([left[k], own[k], right[k]])
                out[k][name] = window.index_select(0, safe_local[k])
        else:
            full = all_gather(own, group=group)
            for k, dev in enumerate(devices):
                out[k][name] = full.index_select(0, idx[k].to(full.device)).to(dev)
    shards = [FilterState(**fields) for fields in out]
    if not config.parity_mode:
        shards = [s.replace(log_weights=uniform_log_weights(s.log_weights, p))
                  for s in shards]
    return shards
