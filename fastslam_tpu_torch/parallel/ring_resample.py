"""The distributed resampler over the ring halo exchange kernel.

Counterpart of ``fastslam_tpu/parallel/ring_resample.py``.  Each shard's
state is packed into one ``[P_local, D]`` float32 block; one launch of the
exchange kernel gives every shard its left and right neighbours' blocks;
then each shard gathers its systematic-resampling ancestors from the
three-block window, or from the whole state when some window does not fit,
with the ancestor-window math of ``parallel/resample.py``.

The TPU kernel moves the blocks between chips with remote DMAs behind a
neighbour barrier.  Here:

* within one process (its shards on one card) one launch moves the whole
  ring and stream order stands in for the barrier
  (``core/cuda_kernels/ring.py:ring_halo_exchange``);
* on a mesh that spans the processes of a group, each process launches the
  kernel's cross-process form once per call
  (``core/cuda_kernels/ring.py:ring_halo_exchange_peers``): it writes into one
  of two sets of its neighbour processes' receive buffers, by call parity,
  through CUDA IPC mappings, and its stream waits on their flags in device
  memory on the front end, never on an SM.  The weights, the halo-or-fallback
  decision and the fallback's whole-state gather run over the group.  The
  halos it returns live in the ring's persistent buffers, so
  :func:`_ring_body` consumes them (``index_select`` into new tensors)
  before it returns: no result aliases a receive buffer.

On CPU shards the wrappers run their plain versions: the in-process copy,
and two ring shifts of ``parallel/collectives.py:ppermute`` over the group.
On a 2-D mesh each map column is resampled as a ring of its own, as the halo
resampler does.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.core.state import FilterState
from fastslam_tpu_torch.parallel.collectives import all_gather, site
from fastslam_tpu_torch.parallel.mesh import ParticleMesh, columns, from_columns
from fastslam_tpu_torch.parallel.resample import (
    pack_particle_block, shard_ancestor_window, uniform_log_weights,
    unpack_particle_block,
)


def _kernel_exchange(blocks, devices, group):
    """Both halos of every shard in one launch of the exchange kernel, of its
    cross-process form on a ring over ``group``."""
    if group is None:
        return cuda_kernels.ring_halo_exchange(blocks)
    return cuda_kernels.ring_halo_exchange_peers(blocks, group)


def _ppermute_exchange(blocks, devices, group=None):
    """The plain exchange with the kernel's ``(lefts, rights)`` contract: two
    ring shifts of the collectives module (over ``group``, if any)."""
    return cuda_kernels.ring_halo_exchange_peers_ref(blocks, group)


def _ring_body(shards: Sequence[FilterState], u0: torch.Tensor, devices, group, p: int,
               parity: bool, exchange=None) -> List[FilterState]:
    """Pack, exchange, gather from the window (or the whole state), unpack:
    one ring of shards over ``group`` (None: this process's alone), ``p``
    particles in all."""
    l = shards[0].max_landmarks
    idx, safe_local, use_halo = shard_ancestor_window(
        [s.log_weights for s in shards], u0, group)
    blocks = [pack_particle_block(s.poses, s.log_weights, s.lm_mean, s.lm_cov,
                                  s.lm_count) for s in shards]
    lefts, rights = (exchange or _kernel_exchange)(blocks, devices, group)
    if use_halo:
        new = [torch.cat([lefts[k], blocks[k], rights[k]]).index_select(0, safe_local[k])
               for k in range(len(shards))]
    else:
        full = all_gather(blocks, group=group)
        new = [full.index_select(0, idx[k].to(full.device)).to(dev)
               for k, dev in enumerate(devices)]
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
    kernel: one launch per call in each process (per map column on a 2-D
    mesh), on the halo path and the fallback alike; the cross-process form
    on a mesh that spans processes.  ``_exchange`` (testing) swaps the
    kernel for :func:`_ppermute_exchange` or another function of ``(blocks,
    devices, group) -> (lefts, rights)``."""
    group = mesh.group if mesh.num_processes > 1 else None
    p = mesh.particle_shards * shards[0].num_particles
    with site("ring"):
        out = [_ring_body(col, u0, devs, group, p, config.parity_mode, exchange=_exchange)
               for col, devs in zip(columns(shards, mesh), columns(mesh.devices, mesh))]
    return from_columns(out, mesh)
