"""The particle mesh and the placement of a state on it.

Counterpart of ``fastslam_tpu/parallel/mesh.py``.  A mesh is a 1-D list of
devices, one per shard, in ring order; the particles split into S equal
contiguous ranges, shard ``s`` holding range ``s``.  Each shard holds its own
contiguous tensors: a landmark plane ``[L, P]`` shards on its particle axis
(dim 1), so a column slice of it would be a strided view, which the kernels
refuse; :func:`shard_planes_state` copies each slice.

The list may name one card several times: a ring of S shards then lives on
that card, and every per-shard kernel launch and the ring exchange run there.
Two things are not ported and raise ``NotImplementedError``: the 2-D mesh with
a map axis (``map_parallelism > 1``), and a mesh across distinct devices,
which needs peer access between the cards, the exchange kernel's cross-card
form and ``torch.distributed`` (ROADMAP §1, the cross-card sharded engine).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core.state import FilterState, PlanesState
from fastslam_tpu_torch.parallel.collectives import all_gather, split

_PLANES = ("lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cc", "lm_cd")


def _particle_dim(state, name: str) -> int:
    """The particle axis of a state field: dim 1 of an ``[L, P]`` plane,
    dim 0 of everything else."""
    return 1 if isinstance(state, PlanesState) and name in _PLANES else 0


@dataclass(frozen=True)
class ParticleMesh:
    """A 1-D particle mesh: one device per shard, in ring order."""

    devices: Tuple[torch.device, ...]

    @property
    def num_shards(self) -> int:
        return len(self.devices)


def _physical(device: torch.device) -> Tuple[str, Optional[int]]:
    if device.type == "cuda" and device.index is None:
        return device.type, torch.cuda.current_device()
    return device.type, device.index


def make_mesh(config: FastSLAMConfig,
              devices: Optional[Sequence[Union[torch.device, str]]] = None,
              map_parallelism: int = 1) -> ParticleMesh:
    """The 1-D particle mesh over ``devices`` (one shard each; the same card
    may be named several times).  ``None`` means one shard on the card."""
    if map_parallelism > 1:
        raise NotImplementedError(
            "the 2-D particle x map mesh is not ported (ROADMAP §1, the 2-D "
            "map-axis mesh)")
    devices = tuple(torch.device(d) for d in (devices if devices is not None else ["cuda"]))
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len({_physical(d) for d in devices}) > 1:
        raise NotImplementedError(
            "shards on distinct devices need peer access, the exchange "
            "kernel's cross-card form and torch.distributed (ROADMAP §1, the "
            f"cross-card sharded engine); got {[str(d) for d in devices]}")
    return ParticleMesh(devices)


def state_sharding(mesh: ParticleMesh, num_particles: int) -> List[Tuple[torch.device, slice]]:
    """The placement of ``num_particles`` particles on the mesh: each
    shard's device and its range of particles.  Both layouts share it (the
    JAX package's ``planes_state_sharding`` places the same ranges on dim 1
    of the planes)."""
    s = mesh.num_shards
    if num_particles % s:
        raise ValueError(f"{num_particles} particles do not split into {s} equal shards")
    p_local = num_particles // s
    return [(d, slice(k * p_local, (k + 1) * p_local)) for k, d in enumerate(mesh.devices)]


def _split_state(state, mesh: ParticleMesh):
    state_sharding(mesh, state.num_particles)
    fields = {k: None if v is None else split(v, mesh.devices, _particle_dim(state, k))
              for k, v in state.__dict__.items()}
    return [type(state)(**{k: None if v is None else v[i] for k, v in fields.items()})
            for i in range(mesh.num_shards)]


def shard_state(state: FilterState, mesh: ParticleMesh,
                config: FastSLAMConfig) -> List[FilterState]:
    """Split a blocks-layout state into one state per shard."""
    return _split_state(state, mesh)


def shard_planes_state(state: PlanesState, mesh: ParticleMesh,
                       config: FastSLAMConfig) -> List[PlanesState]:
    """Split a planes-layout state into one state per shard (planes on dim
    1).  A production config drops a redundant ``lm_cc`` plane
    (``cc == cb`` there)."""
    if not config.parity_mode:
        state = state.replace(lm_cc=None)
    return _split_state(state, mesh)


def unshard(shards):
    """Gather the shards back into one state of the same layout, on the
    first shard's device."""
    first = shards[0]
    return type(first)(**{
        k: None if v is None
        else all_gather([getattr(s, k) for s in shards], _particle_dim(first, k))
        for k, v in first.__dict__.items()})
