"""The particle mesh, the map mesh of the pose-graph backend, and the
placement of a state on the particle mesh.

Counterpart of ``fastslam_tpu/parallel/mesh.py`` and of the 1-D ``"map"``
mesh the JAX backend shards landmarks over (:class:`MapMesh`,
``backend/distributed.py``).

A particle mesh is a grid of ``Sp`` particle rows by ``Sm`` map shards
(``Sm = 1``: the 1-D ring of the sharded engine).  The particles split into
``Sp`` equal contiguous ranges, row ``p`` holding range ``p``; with ``Sm > 1``
the landmark slots of the blocks layout split into ``Sm`` equal contiguous
ranges too, shard ``(p, m)`` holding slots ``m L/Sm ... (m+1) L/Sm`` of
``lm_mean``/``lm_cov``.  A sharded state is a list of per-shard states in
row-major order (shard ``(p, m)`` at ``p Sm + m``), each field its own
contiguous tensor: a landmark plane ``[L, P]`` shards on its particle axis
(dim 1), so a column slice of it would be a strided view, which the kernels
refuse, and :func:`shard_planes_state` copies each slice.  ``poses``,
``log_weights`` and ``lm_count`` are held once per particle row: the shards
of a row share those tensors, where the JAX package replicates them over the
map axis.  The planes layout keeps every particle's L slots together (its
kernels read all of them), so it takes a 1-D mesh only.

The device list may name one card several times: the shards then live on
that card, and every per-shard kernel launch and the ring exchange run
there.  A mesh across distinct devices of one process needs peer access
between the cards and the exchange kernel's cross-card form (ROADMAP §1, the
cross-card sharded engine) and raises ``NotImplementedError``.

A mesh may span processes (``group``, or an initialized default process
group; see ``parallel/multihost.py``): the device list then names this
process's shards, every process names as many, and the global shards are
every process's list in rank order.  Each process holds whole particle rows,
``local_rows`` of them, starting at global row ``row_offset``.  The
collectives run over the group (``parallel/collectives.py``), and
:func:`shard_state`, given the whole state in every process, keeps this
process's shards.  A map mesh is a 1-D list of devices for the backend's
landmark shards, in one process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core.state import FilterState, PlanesState
from fastslam_tpu_torch.parallel.collectives import all_gather

_PLANES = ("lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cc", "lm_cd")
_SLOTS = ("lm_mean", "lm_cov")   # the blocks fields the map axis splits (dim 1)


def _particle_dim(state, name: str) -> int:
    """The particle axis of a state field: dim 1 of an ``[L, P]`` plane,
    dim 0 of everything else."""
    return 1 if isinstance(state, PlanesState) and name in _PLANES else 0


@dataclass(frozen=True)
class ParticleMesh:
    """A particle mesh: this process's shards' devices in row-major order
    over (particle row, map shard), the map axis's size, the axis names, and
    the process group the mesh spans (None: this process alone)."""

    devices: Tuple[torch.device, ...]
    map_shards: int = 1
    axis_names: Tuple[str, ...] = ("particles",)
    process_index: int = 0
    num_processes: int = 1
    group: Any = None

    @property
    def local_rows(self) -> int:
        """Particle rows this process holds."""
        return len(self.devices) // self.map_shards

    @property
    def particle_shards(self) -> int:
        """Particle rows of the whole mesh (``Sp``)."""
        return self.local_rows * self.num_processes

    @property
    def num_shards(self) -> int:
        """Shards of the whole mesh (``Sp Sm``)."""
        return len(self.devices) * self.num_processes

    @property
    def row_offset(self) -> int:
        """The global index of this process's first particle row."""
        return self.process_index * self.local_rows

    @property
    def shape(self) -> Dict[str, int]:
        """Shards per axis, ``{"particles": Sp}`` or ``{"particles": Sp,
        "map": Sm}`` with the config's axis names, as the JAX mesh's."""
        return dict(zip(self.axis_names, (self.particle_shards, self.map_shards)))


@dataclass(frozen=True)
class MapMesh:
    """A 1-D map mesh: one device per landmark shard, in shard order."""

    devices: Tuple[torch.device, ...]

    @property
    def num_shards(self) -> int:
        return len(self.devices)


def _physical(device: torch.device) -> Tuple[str, Optional[int]]:
    if device.type == "cuda" and device.index is None:
        return device.type, torch.cuda.current_device()
    return device.type, device.index


def _one_device(devices) -> Tuple[torch.device, ...]:
    devices = tuple(torch.device(d) for d in (devices if devices is not None else ["cuda"]))
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len({_physical(d) for d in devices}) > 1:
        raise NotImplementedError(
            "shards on distinct devices of one process need peer access and the "
            "exchange kernel's cross-card form (ROADMAP §1 item 5, the cross-card "
            f"engine); got {[str(d) for d in devices]}")
    return devices


def make_map_mesh(devices: Optional[Sequence[Union[torch.device, str]]] = None) -> MapMesh:
    """The 1-D map mesh over ``devices`` (one landmark shard each; the same
    card may be named several times).  ``None`` means one shard on the
    card."""
    return MapMesh(_one_device(devices))


def make_mesh(config: FastSLAMConfig,
              devices: Optional[Sequence[Union[torch.device, str]]] = None,
              map_parallelism: int = 1, group=None) -> ParticleMesh:
    """The particle mesh over ``devices`` (one shard each, in row-major order
    over ``len(devices) / map_parallelism`` particle rows by
    ``map_parallelism`` map shards; the same card may be named in every
    cell).  ``None`` means one shard on the card.

    With ``group``, or when a default process group is initialized, the
    mesh spans the group's processes: every process calls this with its own
    shards, as many in each (the call checks that), and whole particle rows
    (``len(devices)`` a multiple of ``map_parallelism``)."""
    devices = _one_device(devices)
    if map_parallelism < 1 or len(devices) % map_parallelism:
        raise ValueError(f"{len(devices)} shards do not make rows of {map_parallelism} "
                         "map shards")
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    index, count = 0, 1
    if group is not None:
        index, count = dist.get_rank(group), dist.get_world_size(group)
        counts = [None] * count
        dist.all_gather_object(counts, len(devices), group=group)
        if len(set(counts)) > 1:
            raise ValueError(f"every process must hold as many shards; got {counts}")
    names = ((config.particle_axis,) if map_parallelism == 1
             else (config.particle_axis, config.map_axis))
    return ParticleMesh(devices, map_parallelism, names, index, count, group)


class Placement(NamedTuple):
    """Where one shard lives and what it holds: its device, its global
    particles and its landmark slots (``slice(None)``: all of them)."""

    device: torch.device
    particles: slice
    slots: slice


def state_sharding(mesh: ParticleMesh, num_particles: int,
                   max_landmarks: Optional[int] = None) -> List[Placement]:
    """The placement of a blocks state of ``num_particles`` particles and
    ``max_landmarks`` slots on the mesh: each of this process's shards'
    device, particle range and slot range, in shard order.  The particles
    must split into equal rows, and on a 2-D mesh the slots into equal map
    shards."""
    sp, sm = mesh.particle_shards, mesh.map_shards
    if num_particles % sp:
        raise ValueError(f"{num_particles} particles do not split into {sp} equal shards")
    if sm > 1 and (max_landmarks is None or max_landmarks % sm):
        raise ValueError(f"{max_landmarks} landmark slots do not split into {sm} equal "
                         "map shards")
    p_row = num_particles // sp
    l_map = max_landmarks // sm if sm > 1 else None
    out = []
    for i, device in enumerate(mesh.devices):
        row, m = mesh.row_offset + i // sm, i % sm
        slots = slice(m * l_map, (m + 1) * l_map) if sm > 1 else slice(None)
        out.append(Placement(device, slice(row * p_row, (row + 1) * p_row), slots))
    return out


def require_1d(mesh: ParticleMesh) -> None:
    """Refuse a 2-D mesh for the planes layout, as JAX's
    ``planes_state_sharding`` does."""
    if mesh.map_shards > 1:
        raise ValueError("planes sharding requires a 1-D particle-axis mesh")


def planes_state_sharding(mesh: ParticleMesh, num_particles: int) -> List[Placement]:
    """The placement of a planes state on the mesh: as :func:`state_sharding`,
    the particle ranges on dim 1 of the ``[L, P]`` planes and on dim 0 of
    the rest.  The planes step keeps every particle's full landmark block
    local (its kernels read all L slots of their particles), so the mesh must
    be 1-D over the particle axis."""
    require_1d(mesh)
    return state_sharding(mesh, num_particles)


def _shard(t: torch.Tensor, dim: int, particles: slice, device, slots=slice(None)):
    index = (slice(None),) * dim + (particles,)
    if slots != slice(None):
        index = index + (slots,)
    return t[index].to(device).clone(memory_format=torch.contiguous_format)


def _split_state(state, placements: List[Placement], map_shards: int):
    out = []
    for i, (device, particles, slots) in enumerate(placements):
        if i % map_shards == 0:   # a row's first shard: the row's own fields
            row = {k: None if v is None else _shard(v, _particle_dim(state, k), particles, device)
                   for k, v in state.__dict__.items() if k not in _SLOTS}
        out.append(type(state)(**row, **{
            k: _shard(getattr(state, k), 0, particles, device, slots)
            for k in _SLOTS if hasattr(state, k)}))
    return out


def shard_state(state: FilterState, mesh: ParticleMesh,
                config: FastSLAMConfig) -> List[FilterState]:
    """Split a blocks-layout state into this process's shards (row-major;
    the shards of a row share its poses, weights and counts)."""
    return _split_state(state, state_sharding(mesh, state.num_particles, state.max_landmarks),
                        mesh.map_shards)


def shard_planes_state(state: PlanesState, mesh: ParticleMesh,
                       config: FastSLAMConfig) -> List[PlanesState]:
    """Split a planes-layout state into this process's shards (planes on dim
    1); a 1-D mesh only.  A production config drops a redundant ``lm_cc``
    plane (``cc == cb`` there)."""
    placements = planes_state_sharding(mesh, state.num_particles)
    if not config.parity_mode:
        state = state.replace(lm_cc=None)
    return _split_state(state, placements, 1)


def rows(shards: Sequence, mesh: ParticleMesh) -> List[List]:
    """This process's shards grouped by particle row, each row its map
    shards in slot order."""
    sm = mesh.map_shards
    return [list(shards[r * sm:(r + 1) * sm]) for r in range(len(shards) // sm)]


def columns(shards: Sequence, mesh: ParticleMesh) -> List[List]:
    """This process's shards grouped by map shard: column ``m`` is the 1-D
    particle ring of every row's slot block ``m``."""
    sm = mesh.map_shards
    return [list(shards[m::sm]) for m in range(sm)]


def from_columns(cols: Sequence[Sequence[FilterState]], mesh: ParticleMesh) -> List[FilterState]:
    """The inverse of :func:`columns` for blocks states: each row's own
    fields from column 0 (every column holds the same ones), its slot blocks
    from every column."""
    out = []
    for r, head in enumerate(cols[0]):
        out.extend(head.replace(**{k: getattr(col[r], k) for k in _SLOTS}) for col in cols)
    return out


def unshard(shards, mesh: Optional[ParticleMesh] = None):
    """Gather the shards back into one state of the same layout, on the
    first shard's device: every process's shards when the mesh spans a
    group (every process then holds the whole state), each row's slot
    blocks side by side on a 2-D mesh.  Without ``mesh``, the shards are one
    process's 1-D ring."""
    sm, group = (1, None) if mesh is None else (mesh.map_shards, mesh.group)
    by_row = [row[0] for row in rows(shards, mesh)] if mesh else list(shards)
    first = shards[0]
    fields = {}
    for k, v in first.__dict__.items():
        if v is None:
            fields[k] = None
        elif k in _SLOTS and sm > 1:
            fields[k] = all_gather([all_gather([getattr(s, k) for s in row], dim=1)
                                    for row in rows(shards, mesh)], group=group)
        else:
            fields[k] = all_gather([getattr(s, k) for s in by_row], _particle_dim(first, k),
                                   group=group)
    return type(first)(**fields)


def local_rows(tensor: torch.Tensor, mesh: ParticleMesh, dim: int = 0) -> List[torch.Tensor]:
    """This process's particle rows of a global per-particle tensor: equal
    slices along ``dim``, each its own contiguous tensor on its row's
    device."""
    chunks = tensor.chunk(mesh.particle_shards, dim=dim)
    devices = mesh.devices[::mesh.map_shards]
    return [chunks[mesh.row_offset + r].to(d).clone(memory_format=torch.contiguous_format)
            for r, d in enumerate(devices)]
