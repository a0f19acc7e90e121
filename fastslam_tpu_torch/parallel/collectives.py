"""Collectives of the particle mesh, for one controller that holds every shard.

Under ``shard_map`` and GSPMD the JAX package runs one program per device,
and XLA inserts the collectives between them.  The port runs one Python
program that holds the shards' tensors as a list in shard order and loops
over it, so each collective is an operation on that list:

* :func:`all_gather`: concatenation in shard order;
* :func:`psum`: the sum of per-shard integers or flags;
* :func:`ppermute`: a shift along the ring, each shard's tensor copied to
  its neighbour's device;
* the shard index is the controller's loop variable; :func:`shard_range`
  gives the global particles that shard holds.

Float reductions over particles (weight normalization, Neff, the argmax
pose) gather the ``[P]`` vector and call the single-device function, so S
shards agree with one shard bit for bit.  The JAX package reduces within
each shard and combines the partial results, which agrees with one device
only within rounding.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def shard_range(shard: int, p_local: int) -> slice:
    """The global particle indices of shard ``shard`` (``p_local`` each)."""
    return slice(shard * p_local, (shard + 1) * p_local)


def all_gather(tensors: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` in shard order, on the
    first shard's device."""
    device = tensors[0].device
    return torch.cat([t.to(device) for t in tensors], dim=dim)


def split(tensor: torch.Tensor, devices: Sequence[torch.device],
          dim: int = 0) -> List[torch.Tensor]:
    """The inverse of :func:`all_gather`: equal slices along ``dim``, one per
    device, each its own contiguous tensor on its device."""
    chunks = tensor.chunk(len(devices), dim=dim)
    return [c.to(d).clone(memory_format=torch.contiguous_format)
            for c, d in zip(chunks, devices)]


def psum(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the shards' integers or flags (0-d tensors), on the first
    shard's device."""
    device = values[0].device
    return torch.stack([v.to(device, torch.int64) for v in values]).sum()


def ppermute(tensors: Sequence[torch.Tensor], shift: int,
             devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """A ring shift: shard ``i`` receives a copy of shard ``i - shift``'s
    tensor (mod S) on its device.  ``shift=1`` gives each shard its left
    neighbour's tensor, ``shift=-1`` its right neighbour's."""
    n = len(tensors)
    return [tensors[(i - shift) % n].to(devices[i], copy=True) for i in range(n)]
