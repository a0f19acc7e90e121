"""Sharded filter steps: the FastSLAM tick over a particle mesh.

Counterpart of ``fastslam_tpu/parallel/sharded.py``.  Each step runs its
per-particle half row by row (propagation or the FastSLAM 2.0 proposal, and
the measurement update: one kernel launch per particle row on CUDA, the
plain versions on the CPU) and its reductions over particles on the gathered
``[P]`` vectors (normalize, Neff, the resample indices, the argmax pose), as
the collectives module sets out.  So S shards agree with one shard, and with
the single-device step, bit for bit, in one process or across a group.

On a 2-D mesh (the blocks step only) a particle row's map shards hold its
landmark slots in ``Sm`` blocks.  The JAX package runs its kernel under
``shard_map`` with the map axis left out of the in_specs, so every particle
row sees all L slots and the result is pinned back to the map sharding; the
port assembles each row's blocks into the ``[L, P_row]`` planes the per-tick
kernel reads, launches it once per row, and splits the result back.

The draws are those of the single-device step, for all P particles (``[P]``
or ``[C, P]`` normals, fs2 noise ``[P, 3]`` or ``[C, 3, P]``, ``u0``); each
row takes its own slice, so S shards consume the same draws as one, and
every process of a group passes the same draws.  The step functions take
and return a list of this process's per-shard states.

The JAX package's decomposed blocks step (its ``use_pallas`` or
``distributed_resample`` branch) always samples the motion proposal, whatever
``proposal_mode`` says; the port's samples the FastSLAM 2.0 proposal under
``uses_fs2``, as the single-device step does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels, kernels
from fastslam_tpu_torch.core.state import Measurements
from fastslam_tpu_torch.parallel.collectives import all_gather, shard_range, site
from fastslam_tpu_torch.parallel.mesh import (
    ParticleMesh, require_1d, local_rows, rows, shard_planes_state, shard_state, unshard,
)
from fastslam_tpu_torch.parallel.resample import halo_systematic_resample


def _local(t, k: int, p_local: int, device, dim: int):
    if t is None:
        return None
    r = shard_range(k, p_local)
    index = (slice(None),) * (dim % t.dim()) + (r,)
    return t[index].to(device).contiguous()


def _local_draws(draws: kernels.Draws, k: int, p_local: int, device) -> kernels.Draws:
    """Particle row ``k``'s slice of the global draws: the particle axis is
    the last of the motion normals and the chunked fs2 noise, the first of
    the per-tick fs2 noise ``[P, 3]``."""
    noise_dim = 0 if draws.noise is not None and draws.noise.dim() == 2 else -1
    return kernels.Draws(rot=_local(draws.rot, k, p_local, device, -1),
                         trans=_local(draws.trans, k, p_local, device, -1),
                         u0=draws.u0.to(device),
                         noise=_local(draws.noise, k, p_local, device, noise_dim))


def _on(measurements: Measurements, device) -> Measurements:
    return Measurements(measurements.range_bearing.to(device),
                        measurements.valid.to(device))


def _sharded_update(shards, update, mesh: ParticleMesh, measurements: Measurements,
                    draws: kernels.Draws) -> List:
    """``update(row, measurements, draws)`` on every particle row this
    process holds (a list of its map shards), with the row's own slice of
    the draws: the per-particle half of a step (the JAX package's
    ``shard_map`` around its kernels).  One result per row."""
    p_local = shards[0].num_particles
    return [update(row, _on(measurements, row[0].device),
                   _local_draws(draws, mesh.row_offset + r, p_local, row[0].device))
            for r, row in enumerate(rows(shards, mesh))]


def _row_propose_and_update(row, rotation, translation, measurements: Measurements,
                            config: FastSLAMConfig, draws: kernels.Draws,
                            proposal_floors=None, evidence_scale=None) -> List:
    """``kernels.propose_and_update`` on one particle row of the blocks
    layout, whose map shards hold its slot blocks in slot order.  The
    shards of the new row share its poses, weights and counts.

    The FastSLAM 2.0 proposal reads the whole map, and the CPU's EKF loop
    takes it whole: they get the row's blocks side by side.  On CUDA the EKF
    pass is one launch of the per-tick kernel over the row's planes, which
    ``cuda_kernels.fused_update`` assembles from the blocks (each block's
    transpose in its row range), with no copy of the whole map."""
    head = row[0]
    if len(row) == 1:
        return [kernels.propose_and_update(head, rotation, translation, measurements, config,
                                           draws, proposal_floors, evidence_scale)]
    means, covs = [s.lm_mean for s in row], [s.lm_cov for s in row]
    joined = head.replace(lm_mean=torch.cat(means, dim=1), lm_cov=torch.cat(covs, dim=1)) \
        if kernels.uses_fs2(config) or head.device.type != "cuda" else head
    state = kernels.propose(joined, rotation, translation, measurements, config, draws,
                            proposal_floors, evidence_scale)
    if head.device.type == "cuda" and kernels.ekf_weights(config):
        logw, means, covs, count = cuda_kernels.fused_update(
            state.poses, state.log_weights, means, covs, head.lm_count,
            measurements.range_bearing, measurements.valid, config)
    else:
        new = kernels.update_particles(state, measurements, config,
                                       update_weights=kernels.ekf_weights(config))
        logw, count = new.log_weights, new.lm_count
        means = [m.contiguous() for m in new.lm_mean.chunk(len(row), dim=1)]
        covs = [c.contiguous() for c in new.lm_cov.chunk(len(row), dim=1)]
    return [head.replace(poses=state.poses, log_weights=logw, lm_mean=m, lm_cov=c,
                         lm_count=count) for m, c in zip(means, covs)]


def _normalize_and_resample(shards, u0: torch.Tensor, config: FastSLAMConfig,
                            mesh: ParticleMesh, resample_fn, shard_fn,
                            distributed: bool = False):
    """Normalize and Neff on the gathered weights, then the conditional
    resample: the halo resampler (``distributed``, blocks layout) or the
    single-device gather of the whole state over the mesh (every process's
    shards), resampled and split back, each process keeping its own.  Every
    process decides the branch on the same gathered weights, so all take it
    together (no collective sits in a branch that could differ)."""
    by_row = rows(shards, mesh)
    log_w = kernels.normalize_log_weights(
        all_gather([row[0].log_weights for row in by_row], group=mesh.group), config)
    shards = [s.replace(log_weights=lw) for row, lw in zip(by_row, local_rows(log_w, mesh))
              for s in row]
    p = log_w.shape[0]
    if bool(kernels.effective_particles(log_w, config) < config.resample_threshold_frac * p):
        if distributed:
            return halo_systematic_resample(shards, u0, mesh, config)
        with site("whole_state"):
            state = unshard(shards, mesh)
            idx = kernels.systematic_resample_indices(torch.exp(state.log_weights), u0)
            shards = shard_fn(resample_fn(state, idx, config), mesh, config)
    return shards


def _estimate_pose(shards, mesh: ParticleMesh) -> torch.Tensor:
    """The pose of the first particle of largest weight, over all shards."""
    heads = [row[0] for row in rows(shards, mesh)]
    poses = all_gather([s.poses for s in heads], group=mesh.group)
    return poses[torch.argmax(all_gather([s.log_weights for s in heads], group=mesh.group))]


def _constrained_step(shards, rotation, translation, measurements: Measurements,
                      config: FastSLAMConfig, mesh: ParticleMesh, draws: kernels.Draws,
                      proposal_floors=None, evidence_scale=None):
    """``kernels.fastslam_step`` over the mesh (blocks layout)."""
    update = lambda row, ms, d: _row_propose_and_update(
        row, rotation, translation, ms, config, d, proposal_floors, evidence_scale)
    shards = [s for row in _sharded_update(shards, update, mesh, measurements, draws)
              for s in row]
    shards = _normalize_and_resample(shards, draws.u0, config, mesh, kernels.resample_state,
                                     shard_state, distributed=config.distributed_resample)
    return shards, _estimate_pose(shards, mesh)


def make_sharded_step(config: FastSLAMConfig, mesh: ParticleMesh):
    """The blocks-layout filter step for the mesh, 1-D or 2-D, in one
    process or across a group: ``step(shards, rotation, translation,
    measurements, draws, *, proposal_floors=None, evidence_scale=None) ->
    (shards, pose [3])``, with the global draws (every process passes the
    same).  On CUDA shards the measurement update is one launch of the
    per-tick kernel per particle row (``cuda_kernels.fused_update``, over
    the row's map shards); on the CPU the loop of ``update_particles``.
    ``config.distributed_resample`` resamples with
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
    update = lambda row, ms, d: kernels.planes_update(
        row[0], rotation, translation, ms, config, d, proposal_floors=proposal_floors,
        evidence_scale=evidence_scale)
    shards = _sharded_update(shards, update, mesh, measurements, draws)
    shards = _normalize_and_resample(shards, draws.u0, config, mesh,
                                     kernels.resample_planes_state, shard_planes_state)
    return shards, _estimate_pose(shards, mesh)


def make_sharded_planes_step(config: FastSLAMConfig, mesh: ParticleMesh):
    """The planes-layout filter step for the mesh, with the motion or the
    FastSLAM 2.0 proposal: ``step(shards, rotation, translation,
    measurements, draws, *, proposal_floors=None, evidence_scale=None) ->
    (shards, pose [3])``, one launch of the per-tick kernel per shard, in one
    process or across a group.  The shards' planes are updated in place.  A
    1-D mesh only (the planes layout keeps every particle's slots together)."""
    require_1d(mesh)

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
        shards, lambda row, ms, d: kernels.chunk_update(
            row[0], rotations.to(row[0].device), translations.to(row[0].device), ms, config,
            d, proposal_floors=proposal_floors, evidence_scale=evidence_scale),
        mesh, measurements, draws)
    trajectory = tuple(all_gather([o[0][i] for o in outs], dim=1, group=mesh.group)
                       for i in range(4))
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
    require_1d(mesh)
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
