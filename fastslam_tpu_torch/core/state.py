"""Filter state in the planes layout, as torch tensors.

Each landmark component is an ``[L, P]`` plane: landmark slots on the rows,
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
