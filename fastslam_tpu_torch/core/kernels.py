"""FastSLAM filter steps, vectorized over particles.

Counterpart of ``fastslam_tpu/core/kernels.py``:

* the planes engine: propagation, weight normalization, Neff, the
  search-free systematic resample, the FastSLAM 2.0 prior scalars, and the
  per-tick and chunked steps around the fused kernels of
  :mod:`fastslam_tpu_torch.core.cuda_kernels`, with the motion proposal or
  the FastSLAM 2.0 one (``proposal_mode``);
* the blocks engine (:class:`~fastslam_tpu_torch.core.state.FilterState`):
  association, the per-measurement landmark EKF (``update_particles``, a
  loop over measurements where JAX scans), the FastSLAM 2.0 proposal
  ``fastslam2_propose``, ``resample_state``, ``estimate_pose`` and
  ``fastslam_step``.  On CUDA tensors ``update_particles`` runs the per-tick
  motion kernel through :func:`~fastslam_tpu_torch.core.cuda_kernels.fused_update`
  (the JAX package's ``use_pallas`` branch); on the CPU, the loop.

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
from fastslam_tpu_torch.core.state import FilterState, Measurements, PlanesState

_TWO_PI = 2.0 * math.pi
_LOG_TWO_PI = math.log(2.0 * math.pi)


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
    return torch.where(s < 1.0 / n, float(n), 1.0 / torch.clamp_min(s, 1e-300))


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


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed order, on any device: zeros pad
    the axis to a power of two, then ``x[i] += x[i + h]`` for h = half, ...,
    1.  The fused ICP kernel (``csrc/icp_nn.cu``: ``tree_sums``) adds in
    this order, so its sums equal these bit for bit; ``torch.sum`` adds in
    an order of its own on each device."""
    n = x.shape[-1]
    p2 = 1 << max(n - 1, 0).bit_length()
    x = torch.nn.functional.pad(x, (0, p2 - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


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


def resample_state(state: FilterState, idx: torch.Tensor,
                   config: FastSLAMConfig) -> FilterState:
    """Ancestor gather of the blocks-layout state along the particle axis.
    Parity keeps the copied weights; production resets them to uniform."""
    n = state.num_particles
    idx = idx.to(torch.int64)
    if config.parity_mode:
        new_log_w = state.log_weights.index_select(0, idx)
    else:
        new_log_w = torch.full((n,), -math.log(n), dtype=state.log_weights.dtype,
                               device=state.device)
    return state.replace(
        poses=state.poses.index_select(0, idx),
        log_weights=new_log_w,
        lm_mean=state.lm_mean.index_select(0, idx),
        lm_cov=state.lm_cov.index_select(0, idx),
        lm_count=state.lm_count.index_select(0, idx),
    )


def estimate_pose(state) -> torch.Tensor:
    """The pose of the highest-weight particle (the first of equal maxima,
    as ``jnp.argmax``), gathered on the device."""
    return state.poses.index_select(0, torch.argmax(state.log_weights).reshape(1))[0]


def _normalize_and_resample(state, u0: torch.Tensor, config: FastSLAMConfig,
                            resample=resample_planes_state, *, on_device: bool = False):
    """Normalize, Neff, and the conditional systematic resample of either
    layout (``resample`` gathers the state by ancestor index).

    The host reads the decision ``neff < threshold * P`` and gathers only
    when it holds.  ``on_device=True`` keeps the decision on the device, as
    JAX's ``lax.cond`` does, so a CUDA graph can capture the step: the
    staircase indices are always computed from the same ``u0``, replaced by
    ``arange(P)`` when no resample is due, and the state is always gathered;
    the weights are the resampled ones or the normalized ones by the same
    decision.  An identity gather copies every value, so both forms leave
    the same state bit for bit; the device form costs one read and one write
    of the state per tick."""
    log_w = normalize_log_weights(state.log_weights, config)
    state = state.replace(log_weights=log_w)
    p = state.num_particles
    neff = effective_particles(log_w, config)
    do_resample = neff < config.resample_threshold_frac * p
    if not on_device:
        if bool(do_resample):
            idx = systematic_resample_indices(torch.exp(log_w), u0)
            state = resample(state, idx, config)
        return state
    idx = systematic_resample_indices(torch.exp(log_w), u0)
    idx = torch.where(do_resample, idx, torch.arange(p, device=idx.device))
    gathered = resample(state, idx, config)
    return gathered.replace(
        log_weights=torch.where(do_resample, gathered.log_weights, log_w))


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

def planes_update(state: PlanesState, rotation, translation,
                  measurements: Measurements, config: FastSLAMConfig, draws: Draws,
                  *, proposal_floors=None, evidence_scale=None) -> PlanesState:
    """The per-particle half of :func:`fastslam_step_planes`: propagate and
    update (motion proposal), or predict the mean motion and run the fused
    FastSLAM 2.0 tick (``uses_fs2``), in one kernel launch.  Every particle is
    independent of the others, so a shard of the state runs it on its own
    slice of ``draws``.  The planes, weights and counts of ``state`` are
    updated in place; the returned state is the one to keep."""
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
    return state.replace(poses=poses, log_weights=logw, lm_mx=mx, lm_my=my,
                         lm_ca=ca, lm_cb=cb, lm_cc=cc, lm_cd=cd, lm_count=cnt)


def fastslam_step_planes(state: PlanesState, rotation, translation,
                         measurements: Measurements, config: FastSLAMConfig,
                         draws: Draws, *, proposal_floors=None,
                         evidence_scale=None, on_device: bool = False
                         ) -> Tuple[PlanesState, torch.Tensor]:
    """One filter tick: :func:`planes_update` (the kernels run on CUDA,
    their plain versions on the CPU), then normalize, Neff, conditional
    systematic resample, argmax pose estimate.  ``proposal_floors`` and
    ``evidence_scale`` (the mode dial) feed the fs2 proposal only.
    ``on_device=True`` decides the resample on the device
    (:func:`_normalize_and_resample`): the step then reads nothing on the
    host, and leaves the same state bit for bit.

    The planes, weights and counts of ``state`` are updated in place; the
    returned state is the one to keep.  Returns ``(new_state, pose [3])``.
    """
    state = planes_update(state, rotation, translation, measurements, config, draws,
                          proposal_floors=proposal_floors, evidence_scale=evidence_scale)
    state = _normalize_and_resample(state, draws.u0, config, on_device=on_device)
    # argmax returns the first of equal maxima, as jnp.argmax does
    return state, estimate_pose(state)


def chunk_update(state: PlanesState, rotations: torch.Tensor, translations: torch.Tensor,
                 measurements: Measurements, config: FastSLAMConfig, draws: Draws, *,
                 proposal_floors=None, evidence_scale=None):
    """The per-particle part of :func:`fastslam_steps_planes_chunked`: one
    launch of the chunked kernel.  Returns ``(trajectory, state)``: the
    per-tick ``(tx, ty, tyaw, tlogw)``, each ``[C, P]``, and the state with
    the chunk's planes and counts and its last tick's poses and (not yet
    normalized) weights."""
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
    state = state.replace(
        poses=torch.stack([tx[c - 1], ty[c - 1], tyaw[c - 1]], dim=-1),
        log_weights=tlogw[c - 1],
        lm_mx=mx, lm_my=my, lm_ca=ca, lm_cb=cb, lm_cc=cc, lm_cd=cd,
        lm_count=cnt,
    )
    return (tx, ty, tyaw, tlogw), state


def chunk_estimates(trajectory) -> torch.Tensor:
    """Per-tick pose estimates ``[C, 3]`` of a chunk's trajectory: the pose
    of the first particle of largest (unnormalized) log-weight per tick."""
    tx, ty, tyaw, tlogw = trajectory
    best = torch.argmax(tlogw, dim=1)                        # [C], first max
    ticks = torch.arange(tx.shape[0], device=tx.device)
    return torch.stack([tx[ticks, best], ty[ticks, best], tyaw[ticks, best]], dim=-1)


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
    trajectory, state = chunk_update(state, rotations, translations, measurements,
                                     config, draws, proposal_floors=proposal_floors,
                                     evidence_scale=evidence_scale)
    est = chunk_estimates(trajectory)
    state = _normalize_and_resample(state, draws.u0, config)
    return state, est


# ---------------------------------------------------------------------------
# blocks engine: association and the landmark EKF, one measurement at a time
# ---------------------------------------------------------------------------

def _atan2_f64(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``atan2`` evaluated in float64 and rounded once to the input's type.
    torch's float32 ``atan2`` on the CPU takes one code path for the
    vectorized body of a tensor and another for its tail, which differ in the
    last bit, so a particle's result would depend on the length of the tensor
    it sits in (a shard or the whole set).  Rounded from float64 the two
    paths agree unless the exact value lies within a float64 ulp of a float32
    rounding boundary."""
    return torch.atan2(y.double(), x.double()).to(y.dtype)


def _inv2x2(cov: torch.Tensor, eps: float = 1e-12):
    """Closed-form inverse of flattened 2x2s ``[..., 4]`` = (a, b, c, d);
    returns ``(inverse [..., 4], det)``."""
    a, b, c, d = cov.unbind(-1)
    det = a * d - b * c
    safe = torch.where(det.abs() > eps, det, torch.sign(det) * eps + eps)
    inv_det = 1.0 / safe
    return torch.stack([d, -b, -c, a], dim=-1) * inv_det[..., None], det


def _quadform2(cov_inv: torch.Tensor, v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """``v^T M v`` for flattened 2x2 ``M`` ``[..., 4]`` and vector components."""
    ia, ib, ic, id_ = cov_inv.unbind(-1)
    return v0 * (ia * v0 + ib * v1) + v1 * (ic * v0 + id_ * v1)


def associate(lm_mean: torch.Tensor, lm_cov: torch.Tensor, lm_valid: torch.Tensor,
              query: torch.Tensor, config: FastSLAMConfig):
    """Mahalanobis association of ``query`` ``[P, 2]`` against every slot of
    ``lm_mean`` ``[P, L, 2]`` / ``lm_cov`` ``[P, L, 4]`` (``lm_valid``
    ``[P, L]``): the first slot under the gate in parity mode, the closest in
    production.  Returns ``(idx [P] int32, has_match [P] bool)``."""
    delta = lm_mean - query[:, None, :]
    cov_inv, det = _inv2x2(lm_cov)
    d2 = _quadform2(cov_inv, delta[..., 0], delta[..., 1])
    dist = torch.sqrt(torch.clamp_min(d2, 0.0))
    usable = lm_valid & (det > 0.0)
    dist = torch.where(usable, dist, torch.inf)
    hit = usable & (dist < config.max_landmark_distance)
    has_match = hit.any(dim=1)
    if config.parity_mode:
        idx = torch.argmax(hit.to(torch.int32), dim=1)   # the first hit
    else:
        idx = torch.argmin(dist, dim=1)                   # the best hit
    return idx.to(torch.int32), has_match


def _take_slot(blocks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``blocks[p, idx[p]]`` of ``[P, L, k]`` blocks -> ``[P, k]``."""
    p, _, k = blocks.shape
    return torch.gather(blocks, 1, idx.to(torch.int64)[:, None, None].expand(p, 1, k))[:, 0]


def update_particles_one(poses, log_weights, lm_mean, lm_cov, lm_count, z, z_valid,
                         config: FastSLAMConfig, update_weights: bool = True):
    """One (distance, bearing) measurement ``z`` ``[2]`` (``z_valid`` a 0-d
    bool) against every particle: association (robot-frame query in parity
    mode, world-frame in production), then a landmark EKF update and a
    log-likelihood weight on a match, or an append at slot ``lm_count`` with
    covariance ``default_landmark_cov * I`` on a miss, dropped at capacity.
    ``update_weights=False`` leaves the weights alone (the FastSLAM 2.0
    evidence carries them).  Returns new ``(log_weights, lm_mean, lm_cov,
    lm_count)``."""
    p, l = lm_mean.shape[0], lm_mean.shape[1]
    dist_z, bearing_z = z[0], z[1]
    px, py, yaw = poses[:, 0], poses[:, 1], poses[:, 2]
    slots = torch.arange(l, dtype=torch.int32, device=poses.device)[None, :]
    lm_valid = slots < lm_count[:, None]

    # world-frame observed landmark (appends; production association)
    wx = px + dist_z * torch.cos(yaw + bearing_z)
    wy = py + dist_z * torch.sin(yaw + bearing_z)
    world_obs = torch.stack([wx, wy], dim=-1)
    if config.parity_mode:
        # the reference's robot-frame query, the same for every particle
        rx = dist_z * torch.cos(bearing_z)
        ry = dist_z * torch.sin(bearing_z)
        query = torch.stack([rx, ry]).expand(p, 2)
    else:
        query = world_obs
    idx, has_match = associate(lm_mean, lm_cov, lm_valid, query, config)

    # EKF update of the matched slot
    mu = _take_slot(lm_mean, idx)
    sig = _take_slot(lm_cov, idx)
    dx = mu[:, 0] - px
    dy = mu[:, 1] - py
    q = dx * dx + dy * dy
    q = torch.clamp_min(q, 1e-12)
    r = torch.sqrt(q)
    pred_r = r
    pred_b = _atan2_f64(dy, dx) - yaw
    nu_r = dist_z - pred_r
    nu_b = wrap_angle(bearing_z - pred_b)

    # H = [[dx/r, dy/r], [-dy/q, dx/q]]
    h00 = dx / r
    h01 = dy / r
    h10 = -dy / q
    h11 = dx / q
    a, b, c, d = sig.unbind(-1)
    # S = H Sigma H^T + R
    u0 = h00 * a + h01 * c
    u1 = h00 * b + h01 * d
    v0 = h10 * a + h11 * c
    v1 = h10 * b + h11 * d
    rn = config.measurement_noise
    s00 = u0 * h00 + u1 * h01 + rn
    s01 = u0 * h10 + u1 * h11
    s10 = v0 * h00 + v1 * h01
    s11 = v0 * h10 + v1 * h11 + rn
    s_det = s00 * s11 - s01 * s10
    s_det_safe = torch.clamp_min(s_det.abs(), 1e-18) * torch.sign(s_det + 1e-30)
    i00, i01, i10, i11 = s11 / s_det_safe, -s01 / s_det_safe, -s10 / s_det_safe, s00 / s_det_safe

    # K = Sigma H^T S^-1
    m0 = a * h00 + b * h01
    m1 = c * h00 + d * h01
    n0 = a * h10 + b * h11
    n1 = c * h10 + d * h11
    k00 = m0 * i00 + n0 * i10
    k01 = m0 * i01 + n0 * i11
    k10 = m1 * i00 + n1 * i10
    k11 = m1 * i01 + n1 * i11
    new_mu0 = mu[:, 0] + k00 * nu_r + k01 * nu_b
    new_mu1 = mu[:, 1] + k10 * nu_r + k11 * nu_b

    # (I - K H) Sigma; production symmetrizes it
    g00 = 1.0 - (k00 * h00 + k01 * h10)
    g01 = -(k00 * h01 + k01 * h11)
    g10 = -(k10 * h00 + k11 * h10)
    g11 = 1.0 - (k10 * h01 + k11 * h11)
    new_a = g00 * a + g01 * c
    new_b = g00 * b + g01 * d
    new_c = g10 * a + g11 * c
    new_d = g10 * b + g11 * d
    if not config.parity_mode:
        off = 0.5 * (new_b + new_c)
        new_b = off
        new_c = off

    # Gaussian log-likelihood of the innovation under S
    maha = i00 * nu_r * nu_r + (i01 + i10) * nu_r * nu_b + i11 * nu_b * nu_b
    log_lik = -0.5 * (maha + torch.log(torch.clamp_min(s_det, 1e-30))) - _LOG_TWO_PI

    # merge the hit, miss and invalid paths
    can_append = lm_count < l
    do_update = z_valid & has_match
    do_append = z_valid & ~has_match & can_append
    upd_onehot = (slots == idx[:, None]) & do_update[:, None]
    app_onehot = (slots == lm_count[:, None]) & do_append[:, None]
    new_mean_pl = torch.stack([new_mu0, new_mu1], dim=-1)
    new_cov_pl = torch.stack([new_a, new_b, new_c, new_d], dim=-1)
    dc = config.default_landmark_cov
    app_cov = torch.tensor([dc, 0.0, 0.0, dc], dtype=lm_cov.dtype, device=lm_cov.device)

    lm_mean = torch.where(upd_onehot[..., None], new_mean_pl[:, None, :], lm_mean)
    lm_mean = torch.where(app_onehot[..., None], world_obs[:, None, :], lm_mean)
    lm_cov = torch.where(upd_onehot[..., None], new_cov_pl[:, None, :], lm_cov)
    lm_cov = torch.where(app_onehot[..., None], app_cov, lm_cov)
    lm_count = lm_count + do_append.to(torch.int32)
    if update_weights:
        log_weights = torch.where(do_update, log_weights + log_lik, log_weights)
    return log_weights, lm_mean, lm_cov, lm_count


def update_particles(state: FilterState, measurements: Measurements,
                     config: FastSLAMConfig, update_weights: bool = True) -> FilterState:
    """Every measurement of the tick in order (a measurement may match a
    landmark the one before appended).  On CUDA tensors with
    ``update_weights`` the whole tick is one launch of the per-tick kernel
    (:func:`~fastslam_tpu_torch.core.cuda_kernels.fused_update`); otherwise
    a loop of :func:`update_particles_one`."""
    if update_weights and state.device.type == "cuda":
        log_w, mean, cov, count = cuda_kernels.fused_update(
            state.poses, state.log_weights, state.lm_mean, state.lm_cov,
            state.lm_count, measurements.range_bearing, measurements.valid, config)
        return state.replace(log_weights=log_w, lm_mean=mean, lm_cov=cov, lm_count=count)
    log_w, mean, cov, count = (state.log_weights, state.lm_mean, state.lm_cov,
                               state.lm_count)
    for m in range(measurements.capacity):
        log_w, mean, cov, count = update_particles_one(
            state.poses, log_w, mean, cov, count, measurements.range_bearing[m],
            measurements.valid[m], config, update_weights=update_weights)
    return state.replace(log_weights=log_w, lm_mean=mean, lm_cov=cov, lm_count=count)


# ---------------------------------------------------------------------------
# blocks engine: the FastSLAM 2.0 proposal
# ---------------------------------------------------------------------------

def _inv3x3_sym(m):
    """Closed-form inverse of symmetric 3x3s given as a dict of the six
    entries (a00, a01, a02, a11, a12, a22)."""
    a, b, c = m["a00"], m["a01"], m["a02"]
    d, e, f = m["a11"], m["a12"], m["a22"]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    det = a * co00 + b * co01 + c * co02
    det = torch.where(det.abs() > 1e-18, det, 1e-18)
    inv_det = 1.0 / det
    return {
        "a00": co00 * inv_det,
        "a01": co01 * inv_det,
        "a02": co02 * inv_det,
        "a11": (a * f - c * c) * inv_det,
        "a12": (b * c - a * e) * inv_det,
        "a22": (a * d - b * b) * inv_det,
    }


def _chol3x3_sym(m, jitter: float = 1e-9):
    """Lower Cholesky factor of symmetric 3x3s in the six-entry layout:
    ``(l00, l10, l11, l20, l21, l22)``."""
    a, b, c = m["a00"] + jitter, m["a01"], m["a02"]
    d, e, f = m["a11"] + jitter, m["a12"], m["a22"] + jitter
    l00 = torch.sqrt(torch.clamp_min(a, 1e-18))
    l10 = b / l00
    l20 = c / l00
    l11 = torch.sqrt(torch.clamp_min(d - l10 * l10, 1e-18))
    l21 = (e - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp_min(f - l20 * l20 - l21 * l21, 1e-18))
    return l00, l10, l11, l20, l21, l22


def fastslam2_propose(state: FilterState, rotation, translation,
                      measurements: Measurements, noise: torch.Tensor,
                      config: FastSLAMConfig, xy_floor=None, theta_floor=None,
                      evidence_scale=None) -> Tuple[FilterState, torch.Tensor]:
    """Sample each particle's pose from the measurement-informed posterior
    (FastSLAM 2.0): the information form ``Lambda = P_motion^-1 +
    sum_m Hx' S~^-1 Hx``, ``eta = sum_m Hx' S~^-1 nu_m`` over the
    measurements that associate (and pass the chi^2 gate) at the mean-motion
    predicted pose, then ``N(x_pred + Lambda^-1 eta, Lambda^-1)`` sampled
    with ``noise`` ``[P, 3]``.  ``xy_floor``/``theta_floor`` override the
    config's proposal floors; ``evidence_scale`` (the mode dial in [0, 1])
    scales each measurement's information, never the weight.  With
    ``fs2_evidence_weights`` the weights take the measurement evidence
    ``N(nu; 0, S~ + Hx P0 Hx')``; otherwise the EKF pass weights downstream.

    Returns ``(state with the sampled poses and weights, predicted poses
    [P, 3])``.
    """
    dt = state.poses.dtype
    dev = state.device
    rotation = torch.as_tensor(rotation, dtype=dt, device=dev)
    translation = torch.as_tensor(translation, dtype=dt, device=dev)
    # mean motion (no sampling noise: the uncertainty moves into the proposal)
    # and the motion prior's variances, with floors for invertibility
    rot_eff, trans, s_t2, s_r2, fxy = fs2_prior_scalars(
        rotation, translation, config, (xy_floor, theta_floor))
    yaw_pred = wrap_angle(state.poses[:, 2] + rot_eff)
    px = state.poses[:, 0] + trans * torch.cos(yaw_pred)
    py = state.poses[:, 1] + trans * torch.sin(yaw_pred)

    cy = torch.cos(yaw_pred)
    sy = torch.sin(yaw_pred)
    # P = R diag(s_t2, fxy) R' on xy; theta independent
    p00 = cy * cy * s_t2 + sy * sy * fxy
    p01 = cy * sy * (s_t2 - fxy)
    p11 = sy * sy * s_t2 + cy * cy * fxy
    det_p = p00 * p11 - p01 * p01
    i_p = 1.0 / torch.clamp_min(det_p, 1e-18)
    zeros = torch.zeros_like(p00)
    lam = {"a00": p11 * i_p, "a01": -p01 * i_p, "a02": zeros, "a11": p00 * i_p,
           "a12": zeros, "a22": 1.0 / s_r2 * torch.ones_like(p00)}
    eta0, eta1, eta2 = zeros, zeros, zeros
    log_w_add = zeros
    lm_valid = state.lm_valid_mask()
    rn = config.measurement_noise

    for m in range(measurements.capacity):
        dist_z, bearing_z = measurements.range_bearing[m, 0], measurements.range_bearing[m, 1]
        # associate the world-frame observation from the predicted pose
        wx = px + dist_z * torch.cos(yaw_pred + bearing_z)
        wy = py + dist_z * torch.sin(yaw_pred + bearing_z)
        query = torch.stack([wx, wy], dim=-1)
        idx, has_match = associate(state.lm_mean, state.lm_cov, lm_valid, query, config)
        use = measurements.valid[m] & has_match
        mu = _take_slot(state.lm_mean, idx)
        sig = _take_slot(state.lm_cov, idx)

        dx = mu[:, 0] - px
        dy = mu[:, 1] - py
        q = torch.clamp_min(dx * dx + dy * dy, 1e-12)
        r = torch.sqrt(q)
        nu_r = dist_z - r
        nu_b = wrap_angle(bearing_z - (_atan2_f64(dy, dx) - yaw_pred))

        # landmark-side innovation covariance S~ = Hm Sig Hm' + R
        h00 = dx / r
        h01 = dy / r
        h10 = -dy / q
        h11 = dx / q
        a, b, c, d = sig.unbind(-1)
        u0 = h00 * a + h01 * c
        u1 = h00 * b + h01 * d
        v0 = h10 * a + h11 * c
        v1 = h10 * b + h11 * d
        s00 = u0 * h00 + u1 * h01 + rn
        s01 = u0 * h10 + u1 * h11
        s11 = v0 * h10 + v1 * h11 + rn
        s_det = torch.clamp_min(s00 * s11 - s01 * s01, 1e-18)
        si = 1.0 / s_det
        i00, i01, i11 = s11 * si, -s01 * si, s00 * si

        # chi^2 gate (99 %, 2 dof): an implausible innovation is a likely
        # mis-association and would pull the pose to a wrong consistency
        maha_gate = (i00 * nu_r * nu_r + 2.0 * i01 * nu_r * nu_b
                     + i11 * nu_b * nu_b)
        use = use & (maha_gate < 9.21)

        # pose Jacobian Hx = [[-dx/r, -dy/r, 0], [dy/q, -dx/q, -1]]
        g00, g01, g02 = -h00, -h01, torch.zeros_like(h00)
        g10, g11_, g12 = -h10, -h11, -torch.ones_like(h00)
        # Hx' S~^-1 Hx (symmetric 3x3) and Hx' S~^-1 nu
        t00 = i00 * g00 + i01 * g10
        t01 = i00 * g01 + i01 * g11_
        t02 = i00 * g02 + i01 * g12
        t10 = i01 * g00 + i11 * g10
        t11 = i01 * g01 + i11 * g11_
        t12 = i01 * g02 + i11 * g12
        d00 = g00 * t00 + g10 * t10
        d01 = g00 * t01 + g10 * t11
        d02 = g00 * t02 + g10 * t12
        d11 = g01 * t01 + g11_ * t11
        d12 = g01 * t02 + g11_ * t12
        d22 = g02 * t02 + g12 * t12
        e0 = t00 * nu_r + t10 * nu_b
        e1 = t01 * nu_r + t11 * nu_b
        e2 = t02 * nu_r + t12 * nu_b

        usef = use.to(dt)
        luse = usef if evidence_scale is None else usef * evidence_scale
        lam = {"a00": lam["a00"] + luse * d00, "a01": lam["a01"] + luse * d01,
               "a02": lam["a02"] + luse * d02, "a11": lam["a11"] + luse * d11,
               "a12": lam["a12"] + luse * d12, "a22": lam["a22"] + luse * d22}
        eta0 = eta0 + luse * e0
        eta1 = eta1 + luse * e1
        eta2 = eta2 + luse * e2

        # evidence N(nu; 0, S~ + Hx P0 Hx'), P0 = [[p00,p01,0],[p01,p11,0],[0,0,s_r2]]
        q00 = g00 * (p00 * g00 + p01 * g01) + g01 * (p01 * g00 + p11 * g01)
        q01 = g00 * (p00 * g10 + p01 * g11_) + g01 * (p01 * g10 + p11 * g11_)
        q11 = (g10 * (p00 * g10 + p01 * g11_) + g11_ * (p01 * g10 + p11 * g11_)
               + s_r2 * g12 * g12)
        z00 = s00 + q00
        z01 = s01 + q01
        z11 = s11 + q11
        z_det = torch.clamp_min(z00 * z11 - z01 * z01, 1e-30)
        zi = 1.0 / z_det
        maha = (z11 * nu_r * nu_r - 2.0 * z01 * nu_r * nu_b + z00 * nu_b * nu_b) * zi
        log_ev = -0.5 * (maha + torch.log(z_det)) - _LOG_TWO_PI
        log_w_add = log_w_add + torch.where(use, log_ev, 0.0)

    sigma = _inv3x3_sym(lam)
    mu0 = px + sigma["a00"] * eta0 + sigma["a01"] * eta1 + sigma["a02"] * eta2
    mu1 = py + sigma["a01"] * eta0 + sigma["a11"] * eta1 + sigma["a12"] * eta2
    mu2 = yaw_pred + sigma["a02"] * eta0 + sigma["a12"] * eta1 + sigma["a22"] * eta2
    l00, l10, l11, l20, l21, l22 = _chol3x3_sym(sigma)
    n0, n1, n2 = noise[:, 0], noise[:, 1], noise[:, 2]
    new_x = mu0 + l00 * n0
    new_y = mu1 + l10 * n0 + l11 * n1
    new_yaw = wrap_angle(mu2 + l20 * n0 + l21 * n1 + l22 * n2)
    poses = torch.stack([new_x, new_y, new_yaw], dim=-1)
    # the weight comes from the evidence here XOR the EKF pass, never both
    log_weights = (state.log_weights + log_w_add if config.fs2_evidence_weights
                   else state.log_weights)
    return (state.replace(poses=poses, log_weights=log_weights),
            torch.stack([px, py, yaw_pred], dim=-1))


# ---------------------------------------------------------------------------
# blocks engine: the full step
# ---------------------------------------------------------------------------

def propose(state: FilterState, rotation, translation, measurements: Measurements,
            config: FastSLAMConfig, draws: Draws, proposal_floors=None,
            evidence_scale=None) -> FilterState:
    """Sample the poses: the motion model (which reads only the poses), or
    the FastSLAM 2.0 proposal under ``uses_fs2`` (which reads the map and,
    with ``fs2_evidence_weights``, sets the weights)."""
    if uses_fs2(config):
        fxy, fth = proposal_floors if proposal_floors is not None else (None, None)
        state, _ = fastslam2_propose(state, rotation, translation, measurements,
                                     draws.noise, config, fxy, fth, evidence_scale)
        return state
    return state.replace(poses=propagate_particles(
        state.poses, rotation, translation, config.rotation_noise * draws.rot,
        config.translation_noise * draws.trans))


def ekf_weights(config: FastSLAMConfig) -> bool:
    """Whether the landmark EKF pass sets the weights: always but under the
    FastSLAM 2.0 proposal with ``fs2_evidence_weights``."""
    return not (uses_fs2(config) and config.fs2_evidence_weights)


def propose_and_update(state: FilterState, rotation, translation,
                       measurements: Measurements, config: FastSLAMConfig,
                       draws: Draws, proposal_floors=None,
                       evidence_scale=None) -> FilterState:
    """The per-particle half of :func:`fastslam_step`: :func:`propose`, then
    the tick's measurements through the landmark EKF.  Every particle is
    independent of the others, so a shard of the state runs it on its own
    slice of ``draws``."""
    state = propose(state, rotation, translation, measurements, config, draws,
                    proposal_floors, evidence_scale)
    return update_particles(state, measurements, config, update_weights=ekf_weights(config))


def fastslam_step(state: FilterState, rotation, translation,
                  measurements: Measurements, config: FastSLAMConfig, draws: Draws,
                  *, proposal_floors=None, evidence_scale=None
                  ) -> Tuple[FilterState, torch.Tensor]:
    """One filter tick on the blocks layout: propagate (motion proposal, or
    the FastSLAM 2.0 proposal with ``proposal_floors`` = (xy, theta) and the
    mode dial ``evidence_scale``), per-measurement EKF updates, normalize,
    Neff, conditional systematic resample, argmax pose estimate.  The motion
    draws are ``draws.rot``/``draws.trans`` ``[P]``, the fs2 draws
    ``draws.noise`` ``[P, 3]``.  Returns ``(new_state, pose [3])``."""
    state = propose_and_update(state, rotation, translation, measurements, config,
                               draws, proposal_floors, evidence_scale)
    state = _normalize_and_resample(state, draws.u0, config, resample_state)
    return state, estimate_pose(state)
