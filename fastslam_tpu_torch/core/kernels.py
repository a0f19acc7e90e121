"""FastSLAM filter steps on the planes-layout state, vectorized over particles.

Counterpart of the planes-engine part of ``fastslam_tpu/core/kernels.py``:
propagation, weight normalization, Neff, the search-free systematic
resample, the FastSLAM 2.0 prior scalars, and the per-tick and chunked steps
around the fused kernels of :mod:`fastslam_tpu_torch.core.cuda_kernels`,
with the motion proposal or the FastSLAM 2.0 one (``proposal_mode``).

Every step takes its random draws as tensors (standard normals for the
motion noise or the fs2 pose sample, ``u0`` for the resample), so a test can
hand it the same draws as the JAX step.  :func:`draw` draws them from an
explicit :class:`torch.Generator`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.core.state import Measurements, PlanesState

_TWO_PI = 2.0 * math.pi


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to [-pi, pi) as ``(a + pi) % 2pi - pi``.  The modulo is a
    floor-mod (``torch.remainder``); ``torch.fmod`` would keep the sign of a
    negative angle and return values below -pi."""
    return torch.remainder(theta + math.pi, _TWO_PI) - math.pi


class Draws(NamedTuple):
    """Random inputs of one step, standard normals and the resample offset
    ``u0`` in [0, 1/P).  The motion proposal reads ``rot``/``trans``, ``[P]``
    per tick or ``[C, P]`` per chunk; the FastSLAM 2.0 proposal reads
    ``noise``, ``[P, 3]`` per tick or ``[C, 3, P]`` per chunk."""

    rot: Optional[torch.Tensor]
    trans: Optional[torch.Tensor]
    u0: torch.Tensor
    noise: Optional[torch.Tensor] = None


def uses_fs2(config: FastSLAMConfig) -> bool:
    """Whether the steps sample the FastSLAM 2.0 proposal: production only;
    parity mode runs the motion proposal whatever ``proposal_mode`` says."""
    return config.proposal_mode == "fastslam2" and not config.parity_mode


def draw(generator: torch.Generator, num_particles: int,
         num_ticks: int | None = None, *, fs2: bool = False) -> Draws:
    """Draws of one tick (``num_ticks=None``) or one chunk, on the
    generator's device: motion noise, or the fs2 pose-sample noise."""
    device = generator.device
    normal = lambda *shape: torch.randn(shape, generator=generator, device=device)
    rot = trans = noise = None
    if fs2:
        noise = (normal(num_particles, 3) if num_ticks is None
                 else normal(num_ticks, 3, num_particles))
    else:
        ticks = () if num_ticks is None else (num_ticks,)
        rot, trans = normal(*ticks, num_particles), normal(*ticks, num_particles)
    u0 = torch.rand((), generator=generator, device=device) * (1.0 / num_particles)
    return Draws(rot, trans, u0, noise)


# ---------------------------------------------------------------------------
# motion model
# ---------------------------------------------------------------------------

def propagate_particles(poses: torch.Tensor, rotation, translation,
                        rot_noise: torch.Tensor,
                        trans_noise: torch.Tensor) -> torch.Tensor:
    """Sample the motion model for all particles.

    Motion is either a pure rotation or a pure translation per tick, chosen
    by ``rotation != 0``; noise applies only to the active component; yaw is
    wrapped, then the translation runs along the new heading.
    ``rot_noise``/``trans_noise`` are ``[P]`` draws already scaled by the
    noise std-devs.
    """
    rotation = torch.as_tensor(rotation, dtype=poses.dtype, device=poses.device)
    translation = torch.as_tensor(translation, dtype=poses.dtype, device=poses.device)
    rotating = rotation != 0.0
    noisy_rot = torch.where(rotating, rotation + rot_noise, 0.0)
    noisy_trans = torch.where(rotating, 0.0, translation + trans_noise)
    yaw = wrap_angle(poses[:, 2] + noisy_rot)
    x = poses[:, 0] + noisy_trans * torch.cos(yaw)
    y = poses[:, 1] + noisy_trans * torch.sin(yaw)
    return torch.stack([x, y, yaw], dim=-1)


# ---------------------------------------------------------------------------
# weights / Neff / resampling
# ---------------------------------------------------------------------------

def normalize_log_weights(log_weights: torch.Tensor,
                          config: FastSLAMConfig) -> torch.Tensor:
    """Production: log-sum-exp.  Parity: linear space; reset to uniform if
    the total is below the weight floor, otherwise divide, except weights
    individually below the floor, which stay unnormalized."""
    n = log_weights.shape[0]
    if not config.parity_mode:
        return log_weights - torch.logsumexp(log_weights, dim=0)
    w = torch.exp(log_weights)
    total = torch.sum(w)
    uniform = torch.full_like(w, 1.0 / n)
    scaled = torch.where(w < config.weight_floor, w, w / total)
    w = torch.where(total < config.weight_floor, uniform, scaled)
    return torch.log(torch.clamp_min(w, 1e-300))


def effective_particles(log_weights: torch.Tensor,
                        config: FastSLAMConfig) -> torch.Tensor:
    """Neff = 1 / sum(w^2); N when sum(w^2) < 1/N."""
    n = log_weights.shape[0]
    w = torch.exp(log_weights)
    s = torch.sum(w * w)
    return torch.where(s < 1.0 / n, torch.tensor(float(n), dtype=w.dtype, device=w.device),
                       1.0 / torch.clamp_min(s, 1e-300))


def systematic_resample_indices(weights: torch.Tensor,
                                u0: torch.Tensor) -> torch.Tensor:
    """Low-variance resampling: ancestor of position ``u0 + m/N`` is the first
    index whose cumulative weight reaches it, clipped at N-1."""
    return grid_staircase_indices(fixed_order_cumsum(weights), u0, weights.shape[0])


def fixed_order_cumsum(weights: torch.Tensor) -> torch.Tensor:
    """Cumulative sum of non-negative weights (total below 2^15) that is the
    same on every run: each weight is rounded to a multiple of 2^-48 and the
    sum is taken in int64, exact in any order, then converted back.  A float
    ``torch.cumsum`` on CUDA adds in an order that changes from run to run,
    and one flipped resample index changes the rest of the run."""
    scale = 2.0 ** 48
    q = torch.round(weights.to(torch.float64) * scale).to(torch.int64)
    return (torch.cumsum(q, dim=0).to(torch.float64) / scale).to(weights.dtype)


def grid_staircase_indices(cum: torch.Tensor, u0: torch.Tensor,
                           n: int) -> torch.Tensor:
    """``clip(searchsorted(cum, u0 + arange(n)/n, 'left'), 0, n-1)`` without
    the search: count the grid points at or below each ``cum_j`` in closed
    form (with two float corrections each way against the exact grid
    values), then invert the staircase with a scatter-max and a prefix-max.
    Returns int64 indices, bit-identical to the JAX function on the same
    ``cum`` (its scatter-max becomes ``scatter_reduce(amax)``, its
    ``associative_scan(max)`` becomes ``cummax``)."""
    dt = cum.dtype
    device = cum.device
    u0 = torch.as_tensor(u0, dtype=dt, device=device)
    grid = lambda m: u0 + m.to(dt) / n
    s = torch.ceil((cum - u0) * n).to(torch.int64)
    s = torch.clamp(s, 0, n)
    for _ in range(2):
        s = torch.where((s > 0) & (grid(s - 1) > cum), s - 1, s)
    for _ in range(2):
        s = torch.where((s < n) & (grid(s) <= cum), s + 1, s)

    # each positive-count j owns the output run [S_{j-1}, S_j): scatter j at
    # its run start and forward-fill with a prefix max; zero-count entries go
    # to the dummy slot n; positions past cum[-1] (undersum) take n-1
    s_prev = torch.cat([torch.zeros(1, dtype=torch.int64, device=device), s[:-1]])
    j = torch.arange(n, dtype=torch.int64, device=device)
    start = torch.where(s > s_prev, s_prev, n)
    b = torch.full((n + 1,), -1, dtype=torch.int64, device=device)
    b = b.scatter_reduce(0, start, j, reduce="amax", include_self=True)
    tail = torch.where(s[n - 1] < n, s[n - 1], n).reshape(1)
    b = b.scatter_reduce(0, tail, torch.full((1,), n - 1, dtype=torch.int64, device=device),
                         reduce="amax", include_self=True)
    idx = torch.cummax(b[:n], dim=0).values
    return torch.clamp(idx, 0, n - 1)


def resample_planes_state(state: PlanesState, idx: torch.Tensor,
                          config: FastSLAMConfig) -> PlanesState:
    """Ancestor gather: planes along the particle axis (dim 1), per-particle
    tensors along dim 0.  Parity keeps the copied weights; production resets
    them to uniform."""
    n = state.num_particles
    idx = idx.to(torch.int64)
    if config.parity_mode:
        new_log_w = state.log_weights.index_select(0, idx)
    else:
        new_log_w = torch.full((n,), -math.log(n), dtype=state.log_weights.dtype,
                               device=state.device)
    g = lambda plane: None if plane is None else plane.index_select(1, idx)
    return state.replace(
        poses=state.poses.index_select(0, idx),
        log_weights=new_log_w,
        lm_mx=g(state.lm_mx), lm_my=g(state.lm_my),
        lm_ca=g(state.lm_ca), lm_cb=g(state.lm_cb),
        lm_cc=g(state.lm_cc), lm_cd=g(state.lm_cd),
        lm_count=state.lm_count.index_select(0, idx),
    )


def _normalize_and_resample(state: PlanesState, u0: torch.Tensor,
                            config: FastSLAMConfig) -> PlanesState:
    log_w = normalize_log_weights(state.log_weights, config)
    state = state.replace(log_weights=log_w)
    p = state.num_particles
    neff = effective_particles(log_w, config)
    if bool(neff < config.resample_threshold_frac * p):
        idx = systematic_resample_indices(torch.exp(log_w), u0)
        state = resample_planes_state(state, idx, config)
    return state


def fs2_prior_scalars(rotation, translation, config: FastSLAMConfig,
                      proposal_floors=None):
    """The FastSLAM 2.0 motion prior of one tick (scalars) or a chunk
    (``[C]``): squared floors and the rotation-XOR-translation variances.
    ``proposal_floors`` = (xy, theta) floors, scalars or ``[C]``; ``None``
    takes the config's.  Returns ``(rot_eff, trans_eff, s_t2, s_r2, fxy)``."""
    fxy_f, fth_f = proposal_floors if proposal_floors is not None else (None, None)
    fxy = (config.proposal_xy_floor if fxy_f is None else fxy_f) ** 2
    fth = (config.proposal_theta_floor if fth_f is None else fth_f) ** 2
    rotating = rotation != 0.0
    rot_eff = torch.where(rotating, rotation, 0.0)
    trans_eff = torch.where(rotating, 0.0, translation)
    s_t2 = torch.where(rotating, 0.0, config.translation_noise ** 2) + fxy
    s_r2 = torch.where(rotating, config.rotation_noise ** 2, 0.0) + fth
    return rot_eff, trans_eff, s_t2, s_r2, fxy


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def fastslam_step_planes(state: PlanesState, rotation, translation,
                         measurements: Measurements, config: FastSLAMConfig,
                         draws: Draws, *, proposal_floors=None,
                         evidence_scale=None) -> Tuple[PlanesState, torch.Tensor]:
    """One filter tick: propagate and update (motion proposal), or predict
    the mean motion and run the fused FastSLAM 2.0 tick (``uses_fs2``); then
    normalize, Neff, conditional systematic resample, argmax pose estimate.
    The kernels run on CUDA, their plain versions on the CPU.
    ``proposal_floors`` and ``evidence_scale`` (the mode dial) feed the fs2
    proposal only.

    The planes, weights and counts of ``state`` are updated in place; the
    returned state is the one to keep.  Returns ``(new_state, pose [3])``.
    """
    if uses_fs2(config):
        dev = state.device
        rotation = torch.as_tensor(rotation, dtype=torch.float32, device=dev)
        translation = torch.as_tensor(translation, dtype=torch.float32, device=dev)
        rot_eff, trans_eff, s_t2, s_r2, fxy = fs2_prior_scalars(
            rotation, translation, config, proposal_floors)
        # mean-motion prediction with exact trig
        yaw = wrap_angle(state.poses[:, 2] + rot_eff)
        pred = torch.stack([state.poses[:, 0] + trans_eff * torch.cos(yaw),
                            state.poses[:, 1] + trans_eff * torch.sin(yaw), yaw], dim=-1)
        poses, logw, mx, my, ca, cb, cc, cd, cnt = cuda_kernels.fused_fs2_planes(
            pred, state.log_weights, state.lm_mx, state.lm_my, state.lm_ca,
            state.lm_cb, state.lm_cc, state.lm_cd, state.lm_count,
            measurements.range_bearing, measurements.valid, draws.noise,
            s_t2, s_r2, fxy, config, evidence_scale=evidence_scale,
        )
    else:
        poses = propagate_particles(
            state.poses, rotation, translation,
            config.rotation_noise * draws.rot, config.translation_noise * draws.trans,
        )
        logw, mx, my, ca, cb, cc, cd, cnt = cuda_kernels.fused_update_planes(
            poses, state.log_weights, state.lm_mx, state.lm_my, state.lm_ca,
            state.lm_cb, state.lm_cc, state.lm_cd, state.lm_count,
            measurements.range_bearing, measurements.valid, config,
        )
    state = state.replace(poses=poses, log_weights=logw, lm_mx=mx, lm_my=my,
                          lm_ca=ca, lm_cb=cb, lm_cc=cc, lm_cd=cd, lm_count=cnt)
    state = _normalize_and_resample(state, draws.u0, config)
    # argmax returns the first of equal maxima, as jnp.argmax does
    best = torch.argmax(state.log_weights)
    return state, state.poses[best]


def fastslam_steps_planes_chunked(state: PlanesState, rotations: torch.Tensor,
                                  translations: torch.Tensor,
                                  measurements: Measurements,
                                  config: FastSLAMConfig, draws: Draws, *,
                                  proposal_floors=None, evidence_scale=None
                                  ) -> Tuple[PlanesState, torch.Tensor]:
    """C filter ticks in one call of the chunked update (production only),
    with the motion proposal or the FastSLAM 2.0 one.

    Propagation (or the fs2 mean-motion prediction) runs inside the update;
    normalization, Neff and the resample run at the chunk boundary only.
    Per-tick pose estimates are the argmax of the per-tick (unnormalized)
    log-weights, before the boundary resample.  The motion proposal reads
    ``draws.rot``/``draws.trans`` ``[C, P]``, fs2 ``draws.noise``
    ``[C, 3, P]``; ``proposal_floors`` and ``evidence_scale`` (scalars or
    ``[C]``) feed fs2 only.

    Returns ``(new_state, per-tick poses [C, 3])``.
    """
    if config.parity_mode:
        raise NotImplementedError(
            "chunked execution is a production-mode feature; parity mode "
            "resamples per tick: use fastslam_step_planes")
    c = rotations.shape[0]
    planes = (state.poses, state.log_weights, state.lm_mx, state.lm_my,
              state.lm_ca, state.lm_cb, state.lm_cc, state.lm_cd, state.lm_count,
              measurements.range_bearing, measurements.valid)
    if uses_fs2(config):
        rot_eff, trans_eff, s_t2, s_r2, fxy = fs2_prior_scalars(
            rotations, translations, config, proposal_floors)
        out = cuda_kernels.fused_fs2_planes_multi(
            *planes, draws.noise, rot_eff, trans_eff, s_t2, s_r2, fxy, config,
            evidence_scale=evidence_scale)
    else:
        rot_noise = config.rotation_noise * draws.rot
        trans_noise = config.translation_noise * draws.trans
        rotating = (rotations != 0.0)[:, None]
        noisy_rot = torch.where(rotating, rotations[:, None] + rot_noise, 0.0)
        noisy_trans = torch.where(rotating, 0.0, translations[:, None] + trans_noise)
        out = cuda_kernels.fused_update_planes_multi(
            *planes, noisy_rot.contiguous(), noisy_trans.contiguous(), config)
    tx, ty, tyaw, tlogw, mx, my, ca, cb, cc, cd, cnt = out

    best = torch.argmax(tlogw, dim=1)                        # [C], first max
    ticks = torch.arange(c, device=tx.device)
    est = torch.stack([tx[ticks, best], ty[ticks, best], tyaw[ticks, best]], dim=-1)

    state = state.replace(
        poses=torch.stack([tx[c - 1], ty[c - 1], tyaw[c - 1]], dim=-1),
        log_weights=tlogw[c - 1],
        lm_mx=mx, lm_my=my, lm_ca=ca, lm_cb=cb, lm_cc=cc, lm_cd=cd,
        lm_count=cnt,
    )
    state = _normalize_and_resample(state, draws.u0, config)
    return state, est
