"""The sharded dry run: every sharded step and both distributed resamplers on
a mesh of ``n_shards`` shards of one device.

Counterpart of the JAX package's multi-chip dry run
(``__graft_entry__.py:dryrun_multichip``) and of
``scripts/check_ring_resample.py``, with the same steps, shapes and checks:

* the blocks step (motion in parity mode, as the JAX dry run's default
  config; motion in production with the halo resampler inside the step;
  FastSLAM 2.0), the planes step (motion, parity; FastSLAM 2.0) and the
  chunked step (motion; FastSLAM 2.0; FastSLAM 2.0 with the adaptive floors
  0.002 and the mode dial ``[1, 0.5, 0, ...]``);
* one forced resample through ``halo_systematic_resample`` and through
  ``ring_halo_resample``, each bit-identical to the single-device
  ``resample_state``.  On CUDA the ring resampler runs the exchange kernel
  (its cross-process form when the mesh spans a process group, as
  :func:`check_resamplers` is given by ``chip_smoke.py``'s processes); the
  JAX dry run substituted its ppermute exchange only because the CPU cannot
  lower remote DMAs.

The JAX dry run's distributed pose-graph backend block is
:func:`dryrun_backend`: 8 keyframes, 3 landmarks, ``optimize_sharded`` on a
map mesh of ``n_shards`` shards of the device, 2 iterations (on CUDA the
Schur sums launch the segment-sum kernel, 4 times per shard per iteration).

Usage: ``python -m fastslam_tpu_torch.parallel.dryrun [n_shards] [device]``
runs both.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fastslam_tpu_torch.backend.builder import build_pose_graph
from fastslam_tpu_torch.backend.distributed import optimize_sharded
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels, kernels
from fastslam_tpu_torch.core.state import (
    Measurements, init_planes_state, init_state, pad_measurements,
)
from fastslam_tpu_torch.parallel.mesh import (
    ParticleMesh, make_map_mesh, make_mesh, shard_planes_state, shard_state, unshard,
)
from fastslam_tpu_torch.parallel.resample import (
    halo_systematic_resample, shard_ancestor_window,
)
from fastslam_tpu_torch.parallel.ring_resample import ring_halo_resample
from fastslam_tpu_torch.parallel.sharded import (
    make_sharded_planes_chunked_step, make_sharded_planes_step, make_sharded_step,
)

# the JAX dry run's measurements: (range, bearing)
DRYRUN_MEASUREMENTS = [(2.0, 0.3), (3.5, -0.7)]
# (layout, config changes, the kernel its update launches once per shard per
# tick or chunk on CUDA) of each step of the dry run
MODES = {
    "blocks motion parity": ("blocks", dict(parity_mode=True), "fused_update_planes"),
    "blocks motion production": ("blocks", dict(parity_mode=False, distributed_resample=True),
                                 "fused_update_planes"),
    "blocks fs2": ("blocks", dict(parity_mode=False, proposal_mode="fastslam2"),
                   "fused_update_planes"),
    "planes motion": ("planes", dict(parity_mode=True), "fused_update_planes"),
    "planes fs2": ("planes", dict(parity_mode=False, proposal_mode="fastslam2"),
                   "fused_fs2_planes"),
    "chunked motion": ("chunked", dict(parity_mode=False), "fused_update_planes_multi"),
    "chunked fs2": ("chunked", dict(parity_mode=False, proposal_mode="fastslam2"),
                    "fused_fs2_planes_multi"),
    "chunked fs2 adaptive": ("adaptive", dict(parity_mode=False, proposal_mode="fastslam2"),
                             "fused_fs2_planes_multi"),
}
ADAPTIVE_FLOOR = 0.002


def adaptive_dial(chunk: int, device) -> torch.Tensor:
    """The dry run's mode dial: 1, 0.5, then 0 for the rest of the chunk."""
    dial = torch.zeros(chunk, dtype=torch.float32, device=device)
    dial[0] = 1.0
    if chunk > 1:
        dial[1] = 0.5
    return dial


def run_mode(mode: str, config: FastSLAMConfig, n_shards: Optional[int], device,
             measurements: Measurements, *, chunk: int, ticks: int, seed: int = 0,
             mesh: Optional[ParticleMesh] = None):
    """One step of the dry run from a fresh state: ``ticks`` ticks (``chunk``
    ticks in one call for the chunked steps) on ``n_shards`` shards of
    ``device``, or on ``mesh`` (a 2-D mesh, or one across processes), or on
    the single-device step when both are None, with the same draws either
    way.  Returns ``(final state gathered, estimates [ticks or chunk, 3],
    this process's shards)``."""
    layout, changes, _ = MODES[mode]
    cfg = config.replace(**changes)
    p = cfg.num_particles
    fs2 = kernels.uses_fs2(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    zero, step_len = torch.tensor(0.0, device=device), torch.tensor(0.4, device=device)
    if mesh is None and n_shards is not None:
        mesh = make_mesh(cfg, [device] * n_shards)
    if layout == "blocks":
        state = init_state(cfg, device)
        step = (make_sharded_step(cfg, mesh) if mesh
                else lambda s, r, t, ms, d: kernels.fastslam_step(s, r, t, ms, cfg, d))
    elif layout == "planes":
        state = init_planes_state(cfg, device)
        step = (make_sharded_planes_step(cfg, mesh) if mesh
                else lambda s, r, t, ms, d: kernels.fastslam_step_planes(s, r, t, ms, cfg, d))
    else:
        state = init_planes_state(cfg, device)
        rows = (torch.zeros(chunk, device=device), torch.full((chunk,), 0.4, device=device),
                Measurements(measurements.range_bearing[None].expand(chunk, -1, 2).contiguous(),
                             measurements.valid[None].expand(chunk, -1).contiguous()))
        extra = ()
        if layout == "adaptive":
            floors = torch.full((chunk,), ADAPTIVE_FLOOR, device=device)
            extra = (floors, floors.clone(), adaptive_dial(chunk, device))
        if mesh:
            step = make_sharded_planes_chunked_step(cfg, mesh, chunk,
                                                    adaptive=layout == "adaptive")
        else:
            step = lambda s, r, t, ms, d, *x: kernels.fastslam_steps_planes_chunked(
                s, r, t, ms, cfg, d, **(dict(proposal_floors=x[:2], evidence_scale=x[2])
                                        if x else {}))
    if mesh:
        state = (shard_state if layout == "blocks" else shard_planes_state)(state, mesh, cfg)
    est = []
    if layout in ("blocks", "planes"):
        for _ in range(ticks):
            state, pose = step(state, zero, step_len, measurements,
                               kernels.draw(gen, p, fs2=fs2))
            est.append(pose)
    else:
        state, e = step(state, *rows, kernels.draw(gen, p, chunk, fs2=fs2), *extra)
        est.append(e)
    shards = state if mesh else [state]
    return (unshard(shards, mesh) if mesh else state), torch.stack(est).reshape(-1, 3), shards


def run_steps(config: FastSLAMConfig, n_shards: Optional[int], device,
              measurements: Measurements, *, chunk: int = 4, ticks: int = 3,
              seed: int = 0, modes: Sequence[str] = tuple(MODES),
              mesh: Optional[ParticleMesh] = None) -> Dict[str, dict]:
    """Every step of the dry run (see :func:`run_mode`); per mode the final
    state, the estimates, the shards and the kernel launches it made."""
    out = {}
    for mode in modes:
        with cuda_kernels.counted() as launches:
            state, est, shards = run_mode(mode, config, n_shards, device, measurements,
                                          chunk=chunk, ticks=ticks, seed=seed, mesh=mesh)
        out[mode] = {"state": state, "est": est, "shards": shards, "launches": launches}
    return out


def resampler_state(config: FastSLAMConfig, device, profile: str, seed: int = 0):
    """A blocks state to resample: random poses, maps and counts, and weights
    either healthy (uniform in [0.5, 1.5], normalized) or collapsed onto the
    last three particles (the fallback path)."""
    rng = np.random.default_rng(seed)
    p, l = config.num_particles, config.max_landmarks
    if profile == "healthy":
        w = rng.uniform(0.5, 1.5, p)
    elif profile == "collapsed":
        w = np.full(p, 1e-9)
        w[-3:] = 1.0
    else:
        raise ValueError(f"unknown weight profile {profile!r}")
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return init_state(config, device).replace(
        poses=f32(rng.normal(0, 1, (p, 3))),
        log_weights=torch.log(f32(w / w.sum())),
        lm_mean=f32(rng.normal(0, 3, (p, l, 2))),
        lm_cov=f32(rng.uniform(0.01, 0.2, (p, l, 4))),
        lm_count=torch.tensor(rng.integers(0, l + 1, p), dtype=torch.int32, device=device))


def check_resamplers(config: FastSLAMConfig, n_shards: Optional[int], device, profile: str,
                     u0: float, seed: int = 0, mesh: Optional[ParticleMesh] = None
                     ) -> Dict[str, int]:
    """One forced resample of :func:`resampler_state` through both
    distributed resamplers on ``n_shards`` shards (or on ``mesh``, which may
    span processes: the ring resampler then takes the exchange kernel's
    cross-process form); every field of each must equal the single-device
    ``resample_state`` bit for bit.  Returns the launches of both exchange
    kernels (in-process ``ring_launches``, cross-process
    ``peer_launches``), and whether the halo path was taken."""
    state = resampler_state(config, device, profile, seed)
    u0 = torch.tensor(u0, dtype=torch.float32, device=device)
    want = kernels.resample_state(
        state, kernels.systematic_resample_indices(torch.exp(state.log_weights), u0), config)
    mesh = mesh or make_mesh(config, [device] * n_shards)
    use_halo = shard_ancestor_window(
        [s.log_weights for s in shard_state(state, mesh, config)], u0, mesh.group)[2]
    with cuda_kernels.counted() as launches:
        for name, resample in (("halo", halo_systematic_resample),
                               ("ring", ring_halo_resample)):
            shards = resample(shard_state(state, mesh, config), u0, mesh, config)
            if len(shards) != len(mesh.devices):
                raise AssertionError(f"{name} resampler returned {len(shards)} shards")
            got = unshard(shards, mesh)
            for field in ("poses", "log_weights", "lm_mean", "lm_cov", "lm_count"):
                if not torch.equal(getattr(got, field), getattr(want, field)):
                    raise AssertionError(f"{name} resampler ({profile}): {field} differs "
                                         "from the single-device resample")
    return {"ring_launches": launches.get("ring_halo_exchange", 0),
            "peer_launches": launches.get("ring_halo_exchange_peers", 0),
            "halo_path": int(use_halo)}


def dryrun_multichip(n_shards: int, device="cuda", *, config: Optional[FastSLAMConfig] = None,
                     measurements=DRYRUN_MEASUREMENTS, chunk: int = 4, ticks: int = 1
                     ) -> Dict[str, dict]:
    """Every sharded step once and one forced resample through each
    distributed resampler, on ``n_shards`` shards of ``device``, with the JAX
    dry run's checks: finite estimates of the right shape, the state still
    split over ``n_shards`` shards, the resamplers equal to the
    single-device one.  ``config`` defaults to the JAX dry run's tiny shapes
    (``16 * n_shards`` particles, 8 landmark slots, 4 measurements) with
    ``resample_threshold_frac=1``, so that a step resamples whenever the
    weights are not uniform and the steps' resample paths run.  Returns
    the steps' results (see :func:`run_steps`) and, under ``"resample"``, the
    resamplers' check.  On CUDA each step must have launched its kernel
    once per shard per tick or chunk, and nothing else."""
    if config is None:
        config = FastSLAMConfig(num_particles=16 * n_shards, max_landmarks=8,
                                max_measurements=4, resample_threshold_frac=1.0)
    ms = pad_measurements(config, measurements, device)
    results = run_steps(config, n_shards, device, ms, chunk=chunk, ticks=ticks)
    l, p_local = config.max_landmarks, config.num_particles // n_shards
    on_card = torch.device(device).type == "cuda"
    for mode, r in results.items():
        layout, _, kernel = MODES[mode]
        per_tick = layout in ("blocks", "planes")
        rows = ticks if per_tick else chunk
        launches = {kernel: n_shards * (ticks if per_tick else 1)} if on_card else {}
        if r["launches"] != launches:
            raise AssertionError(f"{mode}: launches {r['launches']}, expected {launches}")
        if r["est"].shape != (rows, 3) or not bool(torch.isfinite(r["est"]).all()):
            raise AssertionError(f"{mode}: estimates {tuple(r['est'].shape)}, finite "
                                 f"{bool(torch.isfinite(r['est']).all())}")
        if len(r["shards"]) != n_shards:
            raise AssertionError(f"{mode}: {len(r['shards'])} shards, not {n_shards}")
        if layout != "blocks" and tuple(r["shards"][0].lm_mx.shape) != (l, p_local):
            raise AssertionError(f"{mode}: a shard's plane is {tuple(r['shards'][0].lm_mx.shape)}")
    results["resample"] = check_resamplers(config, n_shards, device, "healthy", u0=0.003,
                                           seed=5)
    return results


# the backend block's Schur sums per shard per iteration: by landmark, by
# keyframe, by keyframe cell (the cross term), and the back-substitution
BACKEND_SUMS_PER_SHARD = 4


def dryrun_backend(n_shards: int, device="cuda", num_iters: int = 2) -> dict:
    """The JAX dry run's backend block: a loop of 8 keyframes observing 3
    landmarks (every landmark in the first shard's slot range; the factor
    capacity of 24 per shard covers all 24 factors), ``optimize_sharded``
    on a map mesh of ``n_shards`` shards of ``device``.  Checks finite poses
    and error and, on CUDA, ``BACKEND_SUMS_PER_SHARD`` segment-sum launches
    per shard per iteration.  Returns the poses, the error and the
    launches."""
    k = 8
    t = np.linspace(0, 2 * np.pi, k, endpoint=False)
    gt = np.stack([np.cos(t), np.sin(t), t + np.pi / 2], axis=-1)
    lms = np.array([[2.0, 0.0], [0.0, 2.0], [-2.0, 0.5]])
    obs = []
    for i in range(k):
        d = lms - gt[i, :2]
        r = np.hypot(d[:, 0], d[:, 1])
        b = (np.arctan2(d[:, 1], d[:, 0]) - gt[i, 2] + np.pi) % (2 * np.pi) - np.pi
        obs.append(np.stack([r, b], -1))
    graph = build_pose_graph(gt + 0.05, obs, max_landmarks=8 * n_shards,
                             max_factors=24 * n_shards, device=device)
    with cuda_kernels.counted() as launched:
        poses, _, err = optimize_sharded(graph, make_map_mesh([device] * n_shards),
                                         num_iters=num_iters)
    launches = launched.get("segment_sum", 0)
    want = BACKEND_SUMS_PER_SHARD * n_shards * num_iters
    if torch.device(device).type == "cuda" and launches != want:
        raise AssertionError(f"backend: {launches} segment_sum launches, expected {want}")
    if not (bool(torch.isfinite(poses).all()) and np.isfinite(err)):
        raise AssertionError(f"backend: poses finite {bool(torch.isfinite(poses).all())}, "
                             f"error {err}")
    return {"poses": poses, "err": err, "launches": {"segment_sum": launches}}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    n = int(args[0]) if args else 4
    device = args[1] if len(args) > 1 else "cuda"
    results = dryrun_multichip(n, device)
    for mode, r in results.items():
        print(mode, {k: v for k, v in r.items() if k in ("launches", "ring_launches",
                                                         "peer_launches", "halo_path")})
    backend = dryrun_backend(n, device)
    print("backend", {"err": backend["err"], "launches": backend["launches"]})
    print(f"sharded dry run on {n} shards of {device}: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
