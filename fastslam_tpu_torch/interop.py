"""Carry state and configuration across from the JAX package, as numpy.

The JAX package's ``PlanesState``, ``FilterState``, ``FastSLAMConfig`` and the
backend's ``PoseGraph`` are converted by their field names, so both packages can compute on identical inputs (the
parity tests do this).  Nothing here imports JAX: the caller hands over numpy
arrays and plain dictionaries.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from fastslam_tpu_torch.backend.pose_graph import PoseGraph
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core.state import FilterState, PlanesState

# JAX configuration fields the port does not have: the device picks the path
# (use_pallas, pallas_interpret, engine); fs2_reuse_association is retired
JAX_ONLY_CONFIG_FIELDS = frozenset(
    {"use_pallas", "pallas_interpret", "engine", "fs2_reuse_association"})

_STATE_FIELDS = ("poses", "log_weights", "lm_mx", "lm_my", "lm_ca", "lm_cb",
                 "lm_cc", "lm_cd", "lm_count")
_FILTER_FIELDS = ("poses", "log_weights", "lm_mean", "lm_cov", "lm_count")


def _tensor(name: str, array, device) -> torch.Tensor:
    dtype = torch.int32 if name == "lm_count" else torch.float32
    return torch.tensor(np.asarray(array), dtype=dtype, device=device)


def planes_state_from_numpy(arrays: Mapping[str, Optional[np.ndarray]],
                            device: torch.device | str) -> PlanesState:
    """``PlanesState`` fields as numpy arrays (``lm_cc`` may be None or
    missing; the JAX ``rng`` key is ignored) -> the port's tensors."""
    def conv(name):
        a = arrays.get(name)
        if a is None:
            if name == "lm_cc":
                return None
            raise KeyError(f"missing state field {name!r}")
        return _tensor(name, a, device)

    return PlanesState(**{name: conv(name) for name in _STATE_FIELDS})


def planes_state_to_numpy(state: PlanesState) -> Dict[str, Optional[np.ndarray]]:
    """The port's state -> numpy arrays under the JAX field names."""
    return {name: None if getattr(state, name) is None
            else getattr(state, name).detach().cpu().numpy()
            for name in _STATE_FIELDS}


def filter_state_from_numpy(arrays: Mapping[str, np.ndarray],
                            device: torch.device | str) -> FilterState:
    """``FilterState`` fields as numpy arrays (the JAX ``rng`` key is
    ignored) -> the port's blocks-layout tensors."""
    missing = [name for name in _FILTER_FIELDS if arrays.get(name) is None]
    if missing:
        raise KeyError(f"missing state fields {missing}")
    return FilterState(**{name: _tensor(name, arrays[name], device)
                          for name in _FILTER_FIELDS})


def filter_state_to_numpy(state: FilterState) -> Dict[str, np.ndarray]:
    """The port's blocks-layout state -> numpy arrays under the JAX field
    names."""
    return {name: getattr(state, name).detach().cpu().numpy() for name in _FILTER_FIELDS}


def config_from_jax_fields(fields: Mapping[str, object]) -> FastSLAMConfig:
    """A JAX ``FastSLAMConfig`` as a field dictionary
    (``dataclasses.asdict``) -> the port's config.  The JAX-only fields are
    dropped; any other unknown field raises."""
    known = {f.name for f in dataclasses.fields(FastSLAMConfig)}
    unknown = set(fields) - known - JAX_ONLY_CONFIG_FIELDS
    if unknown:
        raise ValueError(f"fields the port does not know: {sorted(unknown)}")
    return FastSLAMConfig(**{k: v for k, v in fields.items() if k in known})


def pose_graph_from_numpy(arrays: Mapping[str, np.ndarray],
                          device: torch.device | str) -> PoseGraph:
    """A ``PoseGraph``'s fields as numpy arrays (``graph._asdict()`` of
    either package) -> the port's graph on ``device``, every field with its
    dtype (float32, int32, bool)."""
    missing = [name for name in PoseGraph._fields if arrays.get(name) is None]
    if missing:
        raise KeyError(f"missing pose-graph fields {missing}")
    return PoseGraph(**{name: torch.from_numpy(np.array(arrays[name])).to(device)
                        for name in PoseGraph._fields})


def pose_graph_to_numpy(graph: PoseGraph) -> Dict[str, np.ndarray]:
    """The port's graph -> numpy arrays under the field names."""
    return {name: getattr(graph, name).detach().cpu().numpy()
            for name in PoseGraph._fields}
