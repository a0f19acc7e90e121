"""Failure detection and recovery of a long-running filter.

Counterpart of ``fastslam_tpu/utils/health.py``.  The failure modes
watched for:

* **NaN/Inf poisoning**: one bad measurement spreads through the state in
  a step;
* **weight degeneracy**: Neff pinned near 1 for many consecutive ticks, the
  proposal far from the posterior;
* **map overflow**: particles whose landmark slots are used up drop new
  landmarks;
* **estimate divergence**: the pose jumping further in a tick than the
  robot can move.

:meth:`HealthMonitor.check` reduces the state on its device (the finiteness
of the log-weights, the float64 sum of squared weights, the mean map fill)
and fetches the three numbers in one small copy, where the JAX monitor
copies every log-weight and count to the host; the issues, thresholds and
Neff (to rounding of the float64 sum) are the JAX monitor's.
:meth:`HealthMonitor.recover` resumes from a checkpoint (its first
``num_particles`` particles and its generator, as JAX's recovery returns the
checkpoint's key), or re-initializes every particle at the last finite pose
with empty maps.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core.state import FilterState, PlanesState, from_planes, init_state


@dataclass
class HealthReport:
    ok: bool
    issues: List[str] = field(default_factory=list)
    neff: float = 0.0
    map_fill_frac: float = 0.0
    step_jump_m: float = 0.0


@dataclass
class HealthMonitor:
    config: FastSLAMConfig
    max_step_jump_m: float = 1.0         # max plausible per-tick pose jump
    degenerate_ticks_limit: int = 20     # consecutive Neff <= 2 ticks
    map_full_warn_frac: float = 0.9

    _degenerate_streak: int = 0
    _prev_pose: Optional[np.ndarray] = None

    def check(self, state, pose) -> HealthReport:
        """Check a state of either layout (both carry ``log_weights`` and
        ``lm_count``) and the tick's pose estimate."""
        issues = []
        pose = np.asarray(pose)
        lw = state.log_weights
        w = torch.exp(lw.to(torch.float64))
        finite, sum_sq, mean_count = torch.stack([
            torch.isfinite(lw).all().to(torch.float64), torch.sum(w * w),
            state.lm_count.to(torch.float64).mean()]).tolist()

        finite = bool(finite) and bool(np.isfinite(pose).all())
        if not finite:
            issues.append("nan_or_inf_state")

        n = state.num_particles
        neff = n if sum_sq < 1.0 / n else 1.0 / max(sum_sq, 1e-300)
        if neff <= 2.0:
            self._degenerate_streak += 1
        else:
            self._degenerate_streak = 0
        if self._degenerate_streak >= self.degenerate_ticks_limit:
            issues.append("weight_degeneracy")

        fill = mean_count / state.max_landmarks
        if fill >= self.map_full_warn_frac:
            issues.append("map_near_capacity")

        jump = 0.0
        if self._prev_pose is not None and finite:
            jump = float(np.linalg.norm(pose[:2] - self._prev_pose[:2]))
            if jump > self.max_step_jump_m:
                issues.append("estimate_jump")
        self._prev_pose = pose if finite else self._prev_pose

        return HealthReport(ok=not issues, issues=issues, neff=float(neff),
                            map_fill_frac=fill, step_jump_m=jump)

    def recover(self, state, pose, checkpoint_path: Optional[str] = None
                ) -> Tuple[FilterState, Optional[torch.Generator]]:
        """A usable blocks-layout state on ``state``'s device and the
        generator to draw from next.

        From a checkpoint, if one is given and loads: its first
        ``config.num_particles`` particles (a JAX checkpoint of the planes
        engine holds P rounded up to the lane tile; JAX's ``from_planes``
        keeps the same first ones) and its generator.  A checkpoint with
        fewer particles than the config raises.  Otherwise every particle is
        re-initialized at the last finite pose with uniform weights and
        empty maps, and the generator is None: the caller's carries on."""
        device = state.device
        if checkpoint_path:
            from fastslam_tpu_torch.io.checkpoint import load_checkpoint

            try:
                st, meta = load_checkpoint(checkpoint_path, device)
            except (OSError, ValueError):
                st = None
            if st is not None:
                return self._first_particles(st), meta["generator"]
        pose = np.asarray(pose)
        if not np.isfinite(pose).all():
            pose = self._prev_pose if self._prev_pose is not None else np.zeros(3)
        st = init_state(self.config, device)
        poses = torch.as_tensor(np.asarray(pose), dtype=st.poses.dtype, device=device)
        self._degenerate_streak = 0
        return st.replace(poses=poses.broadcast_to(st.poses.shape).clone()), None

    def _first_particles(self, state) -> FilterState:
        """The first ``config.num_particles`` particles of a loaded state, in
        the blocks layout."""
        n, have = self.config.num_particles, state.num_particles
        if have < n:
            raise ValueError(f"the checkpoint holds {have} particles, fewer than the "
                             f"config's num_particles = {n}")
        if isinstance(state, PlanesState):
            return from_planes(state, n)
        return FilterState(**{k: v[:n] for k, v in state.__dict__.items()})
