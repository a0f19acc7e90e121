"""Filter state as torch tensors, in the planes layout and the blocks layout.

**Planes** (:class:`PlanesState`, the layout the kernels and the chunked
replay carry).  Each landmark component is an ``[L, P]`` plane: landmark slots on the rows,
particles on the columns, so slot ``l`` of neighbouring particles sits at
neighbouring addresses and a kernel with one thread per particle reads each
row coalesced.  Per-particle quantities are ``[P]`` vectors::

  poses        [P, 3]   particle (x, y, yaw)
  log_weights  [P]      log importance weights
  lm_mx, lm_my [L, P]   landmark means (world frame)
  lm_ca..lm_cd [L, P]   2x2 covariance, row-major (a b / c d)
  lm_count     [P]      occupied landmark slots per particle (int32)

``lm_cc`` is ``None`` in production mode (``parity_mode=False``): the
production EKF symmetrizes every covariance write and appends set
``b = c = 0``, so ``cc == cb`` holds and the plane is not stored.  Parity mode
keeps the asymmetric ``(I-KH)S`` update and a real ``lm_cc`` plane.

The particle count is used as given: the CUDA kernels mask the ragged edge of
their last block themselves, so nothing is padded.

**Blocks** (:class:`FilterState`, the layout of the JAX package's
``fastslam_step`` and of the particle-sharded engine): every per-particle
quantity on the leading axis::

  poses        [P, 3]     particle (x, y, yaw)
  log_weights  [P]        log importance weights
  lm_mean      [P, L, 2]  landmark means (world frame)
  lm_cov       [P, L, 4]  2x2 covariance, row-major (a, b, c, d)
  lm_count     [P]        occupied landmark slots per particle (int32)

:func:`to_planes` and :func:`from_planes` convert between the two.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from fastslam_tpu_torch.config import FastSLAMConfig


@dataclass
class PlanesState:
    """The complete filter state (the random generator is held by the caller)."""

    poses: torch.Tensor               # [P, 3] float
    log_weights: torch.Tensor         # [P] float
    lm_mx: torch.Tensor               # [L, P]
    lm_my: torch.Tensor               # [L, P]
    lm_ca: torch.Tensor               # [L, P]
    lm_cb: torch.Tensor               # [L, P]
    lm_cc: Optional[torch.Tensor]     # [L, P]; None in production mode
    lm_cd: torch.Tensor               # [L, P]
    lm_count: torch.Tensor            # [P] int32

    @property
    def num_particles(self) -> int:
        return self.poses.shape[0]

    @property
    def max_landmarks(self) -> int:
        return self.lm_mx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.poses.device

    def replace(self, **kw) -> "PlanesState":
        return replace(self, **kw)

    def clone(self) -> "PlanesState":
        """A deep copy (the kernels update planes, weights and counts in place)."""
        return PlanesState(**{
            k: None if v is None else v.clone() for k, v in self.__dict__.items()
        })


@dataclass
class FilterState:
    """The complete filter state in the blocks layout (the random generator
    is held by the caller, as for :class:`PlanesState`)."""

    poses: torch.Tensor         # [P, 3] float
    log_weights: torch.Tensor   # [P] float
    lm_mean: torch.Tensor       # [P, L, 2]
    lm_cov: torch.Tensor        # [P, L, 4], row-major 2x2
    lm_count: torch.Tensor      # [P] int32

    @property
    def num_particles(self) -> int:
        return self.poses.shape[0]

    @property
    def max_landmarks(self) -> int:
        return self.lm_mean.shape[1]

    @property
    def device(self) -> torch.device:
        return self.poses.device

    def lm_valid_mask(self) -> torch.Tensor:
        """``[P, L]`` bool, True where a landmark slot is occupied."""
        slots = torch.arange(self.max_landmarks, device=self.device)
        return slots[None, :] < self.lm_count[:, None]

    def replace(self, **kw) -> "FilterState":
        return replace(self, **kw)

    def clone(self) -> "FilterState":
        return FilterState(**{k: v.clone() for k, v in self.__dict__.items()})


def init_state(config: FastSLAMConfig, device: torch.device | str) -> FilterState:
    """Fresh blocks-layout state: all particles at the origin, uniform
    weights, empty maps."""
    p = config.num_particles
    l = config.max_landmarks
    dt = getattr(torch, config.dtype)
    return FilterState(
        poses=torch.zeros((p, 3), dtype=dt, device=device),
        log_weights=torch.full((p,), -math.log(p), dtype=dt, device=device),
        lm_mean=torch.zeros((p, l, 2), dtype=dt, device=device),
        lm_cov=torch.zeros((p, l, 4), dtype=dt, device=device),
        lm_count=torch.zeros((p,), dtype=torch.int32, device=device),
    )


def planes_particle_count(num_particles: int) -> int:
    """Particle count of the planes layout: the count itself.  The JAX
    package rounds it up to the Pallas lane tile; the port's kernels mask
    their ragged edge, so nothing is padded."""
    return num_particles


def to_planes(state: FilterState,
              config: Optional[FastSLAMConfig] = None) -> PlanesState:
    """``[P, L, k]`` blocks -> contiguous ``[L, P]`` planes.  With a
    production ``config`` (``parity_mode=False``) the ``lm_cc`` plane is
    dropped (``None``), since the production covariance keeps
    ``cov[..., 2] == cov[..., 1]``; without a config, or in parity mode, all
    six planes are kept."""
    sym = config is not None and not config.parity_mode
    plane = lambda x, k: x[:, :, k].t().contiguous()
    return PlanesState(
        poses=state.poses.clone(),
        log_weights=state.log_weights.clone(),
        lm_mx=plane(state.lm_mean, 0), lm_my=plane(state.lm_mean, 1),
        lm_ca=plane(state.lm_cov, 0), lm_cb=plane(state.lm_cov, 1),
        lm_cc=None if sym else plane(state.lm_cov, 2),
        lm_cd=plane(state.lm_cov, 3),
        lm_count=state.lm_count.clone(),
    )


def from_planes(state: PlanesState,
                num_particles: Optional[int] = None) -> FilterState:
    """``[L, P]`` planes -> ``[P, L, k]`` blocks (the first
    ``num_particles``); a missing ``lm_cc`` plane reads as ``lm_cb``."""
    p = num_particles or state.num_particles
    cc = state.lm_cc if state.lm_cc is not None else state.lm_cb
    return FilterState(
        poses=state.poses[:p].clone(),
        log_weights=state.log_weights[:p].clone(),
        lm_mean=torch.stack([state.lm_mx.t()[:p], state.lm_my.t()[:p]], dim=-1),
        lm_cov=torch.stack([state.lm_ca.t()[:p], state.lm_cb.t()[:p], cc.t()[:p],
                            state.lm_cd.t()[:p]], dim=-1),
        lm_count=state.lm_count[:p].clone(),
    )


def init_planes_state(config: FastSLAMConfig,
                      device: torch.device | str) -> PlanesState:
    """Fresh state: all particles at the origin, uniform weights, empty maps."""
    p = config.num_particles
    l = config.max_landmarks
    dt = getattr(torch, config.dtype)
    plane = lambda: torch.zeros((l, p), dtype=dt, device=device)
    return PlanesState(
        poses=torch.zeros((p, 3), dtype=dt, device=device),
        log_weights=torch.full((p,), -math.log(p), dtype=dt, device=device),
        lm_mx=plane(), lm_my=plane(), lm_ca=plane(), lm_cb=plane(),
        lm_cc=plane() if config.parity_mode else None,
        lm_cd=plane(),
        lm_count=torch.zeros((p,), dtype=torch.int32, device=device),
    )


class Measurements(NamedTuple):
    """A padded batch of (range, bearing) measurements for one tick
    (``[M, 2]``, ``[M]``) or a chunk of ticks (``[C, M, 2]``, ``[C, M]``)."""

    range_bearing: torch.Tensor   # [..., M, 2] float: (distance, bearing)
    valid: torch.Tensor           # [..., M] bool

    @property
    def capacity(self) -> int:
        return self.range_bearing.shape[-2]


def pad_measurements(config: FastSLAMConfig, range_bearing,
                     device: torch.device | str) -> Measurements:
    """Pack a host-side list/array of (distance, bearing) into a padded batch."""
    arr = np.asarray(range_bearing, dtype=np.float32).reshape(-1, 2)
    m = config.max_measurements
    n = min(arr.shape[0], m)
    out = np.zeros((m, 2), np.float32)
    out[:n] = arr[:n]
    valid = np.zeros((m,), bool)
    valid[:n] = True
    return Measurements(torch.from_numpy(out).to(device),
                        torch.from_numpy(valid).to(device))
