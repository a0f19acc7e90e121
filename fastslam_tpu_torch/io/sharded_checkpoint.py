"""Sharded checkpoints of a particle-mesh state, written by every process in
parallel.

Counterpart of ``fastslam_tpu/io/orbax_checkpoint.py``, on
``torch.distributed.checkpoint`` in place of Orbax.  The ``.npz`` checkpoint
(:mod:`fastslam_tpu_torch.io.checkpoint`) holds one whole state, which on a
mesh across processes would have to be gathered into one process first (at
P = 100,000 the landmark blocks are the bulk of the state).  Here each
process writes only its own shards, under one key per global shard
(``lm_mean/shard_3``), into one checkpoint directory, and a load reads each
process's shards straight back onto the template's devices: no process ever
holds the global state.

The payload is the JAX package's (``orbax_checkpoint.py:37-54``): every state
field but the random key, a threefry ``rng_key_data``, ``format_version``,
``layout`` (0 blocks, 1 planes), ``iteration`` and ``robot_pose``; and, as
the ``.npz`` checkpoint adds, the ``torch.Generator``'s state
(``torch_generator_state``).  A particle row's poses, weights and counts
are written once, under the key of the row's first shard.  The header and
the generator's state are the same in every process (the sharded steps take
global draws), so the checkpoint holds one copy.  Tensors stage through host
memory on the way to disk and back.

Usage (every process of the mesh calls both)::

    save_sharded_checkpoint(dir, shards, mesh=mesh, iteration=t,
                            robot_pose=robot, generator=gen)
    shards, meta = load_sharded_checkpoint(dir, template, mesh=mesh)

where ``template`` is any list of shards with the desired shapes and
devices on the same mesh (``shard_state(init_state(cfg, dev), mesh, cfg)``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed.checkpoint as dcp

from fastslam_tpu_torch.core.state import PlanesState
from fastslam_tpu_torch.io.checkpoint import _threefry_key
from fastslam_tpu_torch.parallel.mesh import ParticleMesh

_FORMAT_VERSION = 1
_ROW_FIELDS = ("poses", "log_weights", "lm_count")


def _header(iteration: int, robot_pose, generator: Optional[torch.Generator],
            planes: bool) -> Dict[str, torch.Tensor]:
    header = {
        "format_version": torch.tensor(_FORMAT_VERSION, dtype=torch.int64),
        "layout": torch.tensor(int(planes), dtype=torch.int64),
        "iteration": torch.tensor(int(iteration), dtype=torch.int64),
        "robot_pose": torch.as_tensor(np.asarray(
            robot_pose if robot_pose is not None else np.zeros(3), np.float64)),
        "rng_key_data": torch.from_numpy(_threefry_key(generator).astype(np.int64)),
    }
    if generator is not None:
        header["torch_generator_state"] = generator.get_state()
    return header


def _shard_keys(shards: Sequence, mesh: ParticleMesh) -> List[Dict[str, str]]:
    """Per local shard, its fields' keys: ``field/shard_<global index>``; a
    row's own fields only under its first shard."""
    first = mesh.process_index * len(mesh.devices)
    return [{k: f"{k}/shard_{first + i}" for k, v in s.__dict__.items()
             if v is not None and (i % mesh.map_shards == 0 or k not in _ROW_FIELDS)}
            for i, s in enumerate(shards)]


def _dist_args(mesh: ParticleMesh) -> dict:
    return {"process_group": mesh.group} if mesh.group is not None else {"no_dist": True}


def save_sharded_checkpoint(path: str, shards: Sequence, *, mesh: ParticleMesh,
                            iteration: int = 0, robot_pose=None,
                            generator: Optional[torch.Generator] = None) -> None:
    """Write this process's shards (either layout) and the loop state into
    the checkpoint directory ``path``; every process of the mesh calls this
    together.  An existing checkpoint there is overwritten."""
    payload = _header(iteration, robot_pose, generator, isinstance(shards[0], PlanesState))
    for s, keys in zip(shards, _shard_keys(shards, mesh)):
        payload.update({key: getattr(s, k).detach().cpu() for k, key in keys.items()})
    dcp.save(payload, storage_writer=dcp.FileSystemWriter(os.path.abspath(path), overwrite=True),
             **_dist_args(mesh))


def _count(names, field: str) -> int:
    return sum(1 for n in names if n.startswith(field + "/shard_"))


def load_sharded_checkpoint(path: str, template: Sequence, *, mesh: ParticleMesh
                            ) -> Tuple[List, dict]:
    """Restore ``(shards, meta)``: this process's shards, shaped as
    ``template``'s (a list of shards on ``mesh``) and on its devices, and
    ``meta`` with ``iteration``, ``robot_pose`` and ``generator`` (a
    :class:`torch.Generator` on the template's device with the saved state,
    or None).  Every process of the mesh calls this together.  Refuses
    another format version, another layout, and a mesh of another global
    shard count."""
    path = os.path.abspath(path)
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    planes = isinstance(template[0], PlanesState)
    header = _header(0, None, None, planes)
    if "torch_generator_state" in saved:
        header["torch_generator_state"] = torch.empty(
            tuple(saved["torch_generator_state"].size), dtype=torch.uint8)
    dcp.load(header, checkpoint_id=path, **_dist_args(mesh))

    version = int(header["format_version"])
    if version != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {version}")
    if bool(header["layout"]) != planes:
        raise ValueError(
            "checkpoint layout does not match the template layout "
            f"(saved {'planes' if header['layout'] else 'blocks'}, template "
            f"{'planes' if planes else 'blocks'})")
    slot_field = "lm_mx" if planes else "lm_mean"
    got_shards, got_rows = _count(saved, slot_field), _count(saved, "poses")
    if (got_shards, got_rows) != (mesh.num_shards, mesh.particle_shards):
        raise ValueError(
            f"the checkpoint holds {got_shards} shards in {got_rows} particle rows; the "
            f"template's mesh has {mesh.num_shards} in {mesh.particle_shards}")

    keys = _shard_keys(template, mesh)
    payload = {key: torch.empty_like(getattr(t, k), device="cpu")
               for t, ks in zip(template, keys) for k, key in ks.items()}
    dcp.load(payload, checkpoint_id=path, **_dist_args(mesh))
    shards, row = [], {}
    for i, (t, ks) in enumerate(zip(template, keys)):
        fields = {k: None if key is None else payload[key].to(getattr(t, k).device)
                  for k, key in ((k, ks.get(k)) for k in t.__dict__)}
        if i % mesh.map_shards == 0:
            row = {k: fields[k] for k in _ROW_FIELDS}
        shards.append(type(t)(**{**fields, **row}))
    generator = None
    if "torch_generator_state" in header:
        generator = torch.Generator(device=template[0].device)
        generator.set_state(header["torch_generator_state"])
    meta = {"iteration": int(header["iteration"]),
            "robot_pose": header["robot_pose"].numpy(), "generator": generator}
    return shards, meta
