"""Sharded filter steps: the FastSLAM tick over a particle mesh.

Counterpart of ``fastslam_tpu/parallel/sharded.py``.  Each step runs its
per-particle half shard by shard (propagation or the FastSLAM 2.0 proposal,
and the measurement update: one kernel launch per shard on CUDA, the plain
versions on the CPU) and its reductions over particles on the gathered
``[P]`` vectors (normalize, Neff, the resample indices, the argmax pose), as
the collectives module sets out.  So S shards agree with one shard, and with
the single-device step, bit for bit.

The draws are those of the single-device step, for all P particles (``[P]``
or ``[C, P]`` normals, fs2 noise ``[P, 3]`` or ``[C, 3, P]``, ``u0``); each
shard takes its own slice, so S shards consume the same draws as one.  The
step functions take and return a list of per-shard states.

The JAX package's decomposed blocks step (its ``use_pallas`` or
``distributed_resample`` branch) always samples the motion proposal, whatever
``proposal_mode`` says; the port's samples the FastSLAM 2.0 proposal under
``uses_fs2``, as the single-device step does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import Measurements
from fastslam_tpu_torch.parallel.collectives import all_gather, shard_range, split
from fastslam_tpu_torch.parallel.mesh import (
    ParticleMesh, shard_planes_state, shard_state, unshard,
)
from fastslam_tpu_torch.parallel.resample import halo_systematic_resample


def _local(t, k: int, p_local: int, device, dim: int):
    if t is None:
        return None
    r = shard_range(k, p_local)
    index = (slice(None),) * (dim % t.dim()) + (r,)
    return t[index].to(device).contiguous()


def _local_draws(draws: kernels.Draws, k: int, p_local: int, device) -> kernels.Draws:
    """Shard ``k``'s slice of the global draws: the particle axis is the last
    of the motion normals and the chunked fs2 noise, the first of the
    per-tick fs2 noise ``[P, 3]``."""
    noise_dim = 0 if draws.noise is not None and draws.noise.dim() == 2 else -1
    return kernels.Draws(rot=_local(draws.rot, k, p_local, device, -1),
                         trans=_local(draws.trans, k, p_local, device, -1),
                         u0=draws.u0.to(device),
                         noise=_local(draws.noise, k, p_local, device, noise_dim))


def _on(measurements: Measurements, device) -> Measurements:
    return Measurements(measurements.range_bearing.to(device),
                        measurements.valid.to(device))


def _sharded_update(shards, update, mesh: ParticleMesh, measurements: Measurements,
                    draws: kernels.Draws):
    """``update(state, measurements, draws)`` on every shard, with its own
    slice of the draws: the per-particle half of a step (the JAX package's
    ``shard_map`` around its kernels)."""
    p_local = shards[0].num_particles
    return [update(s, _on(measurements, dev), _local_draws(draws, k, p_local, dev))
            for k, (s, dev) in enumerate(zip(shards, mesh.devices))]


def _normalize_and_resample(shards, u0: torch.Tensor, config: FastSLAMConfig,
                            mesh: ParticleMesh, resample_fn, shard_fn,
                            distributed: bool = False):
    """Normalize and Neff on the gathered weights, then the conditional
    resample: the halo resampler (``distributed``, blocks layout) or the
    single-device gather of the whole state, split back to the shards."""
    log_w = kernels.normalize_log_weights(all_gather([s.log_weights for s in shards]),
                                          config)
    shards = [s.replace(log_weights=lw) for s, lw in zip(shards, split(log_w, mesh.devices))]
    p = log_w.shape[0]
    if bool(kernels.effective_particles(log_w, config) < config.resample_threshold_frac * p):
        if distributed:
            return halo_systematic_resample(shards, u0, mesh, config)
        state = unshard(shards)
        idx = kernels.systematic_resample_indices(torch.exp(state.log_weights), u0)
        shards = shard_fn(resample_fn(state, idx, config), mesh, config)
    return shards


def _estimate_pose(shards) -> torch.Tensor:
    """The pose of the first particle of largest weight, over all shards."""
    poses = all_gather([s.poses for s in shards])
    return poses[torch.argmax(all_gather([s.log_weights for s in shards]))]


def _constrained_step(shards, rotation, translation, measurements: Measurements,
                      config: FastSLAMConfig, mesh: ParticleMesh, draws: kernels.Draws,
                      proposal_floors=None, evidence_scale=None):
    """``kernels.fastslam_step`` over the mesh (blocks layout)."""
    update = lambda s, ms, d: kernels.propose_and_update(
        s, rotation, translation, ms, config, d, proposal_floors, evidence_scale)
    shards = _sharded_update(shards, update, mesh, measurements, draws)
    shards = _normalize_and_resample(shards, draws.u0, config, mesh, kernels.resample_state,
                                     shard_state, distributed=config.distributed_resample)
    return shards, _estimate_pose(shards)


def make_sharded_step(config: FastSLAMConfig, mesh: ParticleMesh):
    """The blocks-layout filter step for the mesh: ``step(shards, rotation,
    translation, measurements, draws, *, proposal_floors=None,
    evidence_scale=None) -> (shards, pose [3])``.  On CUDA shards the
    measurement update is one launch of the per-tick kernel per shard
    (``cuda_kernels.fused_update``); on the CPU the loop of
    ``update_particles``.  ``config.distributed_resample`` resamples with
    ``halo_systematic_resample``."""
    def step(shards, rotation, translation, measurements, draws, *,
             proposal_floors=None, evidence_scale=None):
        return _constrained_step(shards, rotation, translation, measurements, config,
                                 mesh, draws, proposal_floors, evidence_scale)
    return step


def _constrained_planes_step(shards, rotation, translation, measurements: Measurements,
                             config: FastSLAMConfig, mesh: ParticleMesh,
                             draws: kernels.Draws, proposal_floors=None,
                             evidence_scale=None):
    """``kernels.fastslam_step_planes`` over the mesh."""
    update = lambda s, ms, d: kernels.planes_update(
        s, rotation, translation, ms, config, d, proposal_floors=proposal_floors,
        evidence_scale=evidence_scale)
    shards = _sharded_update(shards, update, mesh, measurements, draws)
    shards = _normalize_and_resample(shards, draws.u0, config, mesh,
                                     kernels.resample_planes_state, shard_planes_state)
    return shards, _estimate_pose(shards)


def make_sharded_planes_step(config: FastSLAMConfig, mesh: ParticleMesh):
    """The planes-layout filter step for the mesh, with the motion or the
    FastSLAM 2.0 proposal: ``step(shards, rotation, translation,
    measurements, draws, *, proposal_floors=None, evidence_scale=None) ->
    (shards, pose [3])``, one launch of the per-tick kernel per shard.  The
    shards' planes are updated in place."""
    def step(shards, rotation, translation, measurements, draws, *,
             proposal_floors=None, evidence_scale=None):
        return _constrained_planes_step(shards, rotation, translation, measurements,
                                        config, mesh, draws, proposal_floors,
                                        evidence_scale)
    return step


def _constrained_planes_chunked(shards, rotations: torch.Tensor,
                                translations: torch.Tensor, measurements: Measurements,
                                config: FastSLAMConfig, mesh: ParticleMesh,
                                draws: kernels.Draws, proposal_floors=None,
                                evidence_scale=None) -> Tuple[List, torch.Tensor]:
    """``kernels.fastslam_steps_planes_chunked`` over the mesh: one launch
    of the chunked kernel per shard, then the per-tick estimates and the
    boundary resample on the gathered weights."""
    dev0 = mesh.devices[0]
    outs = _sharded_update(
        shards, lambda s, ms, d: kernels.chunk_update(
            s, rotations.to(s.device), translations.to(s.device), ms, config, d,
            proposal_floors=proposal_floors, evidence_scale=evidence_scale),
        mesh, measurements, draws)
    trajectory = tuple(all_gather([o[0][i] for o in outs], dim=1) for i in range(4))
    est = kernels.chunk_estimates(trajectory).to(dev0)
    shards = _normalize_and_resample([o[1] for o in outs], draws.u0, config, mesh,
                                     kernels.resample_planes_state, shard_planes_state)
    return shards, est


def make_sharded_planes_chunked_step(config: FastSLAMConfig, mesh: ParticleMesh,
                                     chunk_size: int, adaptive: bool = False):
    """The chunked planes step for the mesh (production only):
    ``step(shards, rotations [C], translations [C], measurements [C, M, ...],
    draws) -> (shards, per-tick estimates [C, 3])``.  With ``adaptive=True``
    (FastSLAM 2.0 only) the step takes three more per-tick rows,
    ``floors_xy [C], floors_th [C], dial [C]``: the adaptive estimator's
    proposal floors and mode dial, as the single-device chunked step takes
    them (``proposal_floors``, ``evidence_scale``)."""
    if config.parity_mode:
        raise ValueError("chunked execution is production-mode only")
    if adaptive:
        if not kernels.uses_fs2(config):
            raise ValueError("adaptive floors and dial are fs2-proposal inputs")

        def step(shards, rotations, translations, measurements, draws,
                 floors_xy, floors_th, dial):
            return _constrained_planes_chunked(
                shards, rotations, translations, measurements, config, mesh, draws,
                proposal_floors=(floors_xy, floors_th), evidence_scale=dial)
        return step

    def step(shards, rotations, translations, measurements, draws):
        return _constrained_planes_chunked(shards, rotations, translations,
                                           measurements, config, mesh, draws)
    return step
