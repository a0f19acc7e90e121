"""The control loop and the offline batch replay.

Counterpart of ``fastslam_tpu/app/runner.py``:

* :class:`SLAMRunner` and :func:`run_driver`: the online loop, one tick at
  a time against any :class:`~fastslam_tpu_torch.drivers.base.Driver` —
  odometry from the previous tick's commands, the optional ICP refinement
  of that odometry with adaptive proposal floors, the frontend (with
  optional corner tracking), one filter step, the dead-reckoning warmup
  gate and the per-tick evaluation against ground truth, and the production
  hooks (viewer snapshots, a JSONL metrics log, checkpoints, health
  monitoring with recovery).  In production mode with ``fuse_online_tick``
  every tick is the fused tick (:meth:`SLAMRunner.tick_fused`): on CUDA one
  replay of a captured CUDA graph, the card's counterpart of JAX's
  one-dispatch tick; parity mode, or ``fuse_online_tick=False``, runs the
  split path (:meth:`SLAMRunner.icp_refine`, then :meth:`SLAMRunner.tick`).
* :func:`replay_chunked`: a recorded log has no feedback from the estimate
  to the commands, so the frontend runs over every scan first, the ICP
  matches of the whole log run as one batch (:func:`icp_floor_stage`), then
  the filter takes ``chunk_size`` ticks per call of the chunked update; the
  ``T mod chunk_size`` tail ticks go through the per-tick step.

Odometry pairing, the warmup and the ground-truth frame match the JAX
runner.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels, kernels
from fastslam_tpu_torch.core.state import (
    FilterState, Measurements, from_planes, init_planes_state, to_planes,
)
from fastslam_tpu_torch.eval.metrics import TickEvaluation, evaluate_tick, trajectory_metrics
from fastslam_tpu_torch.frontend.global_map import cluster_known_landmarks
from fastslam_tpu_torch.frontend.pipeline import (
    extract_corners, measurements_from_corners, scan_to_measurements,
)
from fastslam_tpu_torch.frontend.tracking import (
    TrackState, init_tracks, stable_corners, update_tracks,
)
from fastslam_tpu_torch.io.checkpoint import save_checkpoint
from fastslam_tpu_torch.io.serializer import serialize_tick
from fastslam_tpu_torch.proposal import adaptive
from fastslam_tpu_torch.proposal.icp import icp_point_to_line, rotate_points
from fastslam_tpu_torch.utils.health import HealthMonitor
from fastslam_tpu_torch.utils.logging_utils import MetricsLog
from fastslam_tpu_torch.utils.profiling import PhaseTimer


@dataclass
class RunHistory:
    est_poses: List[np.ndarray] = field(default_factory=list)
    gt_poses: List[np.ndarray] = field(default_factory=list)
    evaluations: List[TickEvaluation] = field(default_factory=list)
    num_measurements: List[int] = field(default_factory=list)
    # final (xy, theta) adaptive proposal floors, when the run adapts them
    # (the floors the last tick's type read; floors are per tick type)
    final_floors: tuple | None = None
    # ((fxy, fth) for rotation ticks, (fxy, fth) for translation ticks) at
    # the end of an online run
    final_floors_by_type: tuple | None = None
    # per-tick floor trajectories (batched replay only)
    floor_traj: tuple | None = None
    # host-clock seconds of the online loop's stages, summed over its ticks:
    # on the split path "icp_refine" and "tick" (frontend + filter step), on
    # the fused path "tick" (the whole fused tick), and each production hook
    # that is on ("health", "metrics", "serialize", "checkpoint"); each ends
    # in a device-to-host copy or a file write, so no synchronization is
    # added to time them
    stage_seconds: dict = field(default_factory=dict)
    # replays of the fused tick's captured CUDA graph (0 off the card)
    graph_replays: int = 0

    def metrics(self, skip: int = 0) -> dict:
        return trajectory_metrics(
            np.asarray(self.gt_poses[skip:]), np.asarray(self.est_poses[skip:])
        )


def _check_adaptive(config: FastSLAMConfig) -> None:
    if config.adaptive_proposal_floors and not (
        config.use_icp_proposal and config.proposal_mode == "fastslam2"
    ):
        raise ValueError(
            "adaptive_proposal_floors estimates the odometry error from "
            "the ICP-vs-command residual and feeds it to the fastslam2 "
            "proposal: requires use_icp_proposal=True and "
            "proposal_mode='fastslam2'"
        )


def _f32(x, device) -> torch.Tensor:
    """A host scalar as a 0-d float32 tensor (squared in float32 downstream)."""
    return torch.tensor(np.float32(x), device=device)


class SLAMRunner:
    """Owns the filter state on ``device``, its random generator and the
    dead-reckoned robot pose of the online loop.

    In production mode with ``fuse_online_tick`` the online loop runs
    :meth:`tick_fused`; on CUDA its work is one captured CUDA graph, replayed
    once per tick.  ``graph=False`` runs the same fused tick eagerly on the
    card: the reference the graph is held against, bit for bit."""

    def __init__(self, config: FastSLAMConfig, rng: int = 0, *,
                 device: torch.device | str = "cuda", graph: bool = True):
        _check_adaptive(config)
        self.config = config
        self.device = torch.device(device)
        self.state = init_planes_state(config, self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(rng)
        self._fs2 = kernels.uses_fs2(config)
        self.robot = np.zeros(3)  # dead-reckoned pose during warmup
        self.iteration = 0
        self._prev_timestamp: Optional[float] = None
        self._last_num_measurements = 0
        self._tracks: Optional[TrackState] = (
            init_tracks(config.track_capacity, self.device)
            if config.track_corners else None)

        # host-side state of the online odometry-error estimator
        # (proposal/adaptive.py, shared with the batched replay)
        self._adaptive_floors = bool(config.adaptive_proposal_floors)
        self._floor_xy = config.proposal_xy_floor
        self._floor_th = config.proposal_theta_floor
        self._blend_xy = 0.0
        self._blend_th = 0.0
        self._bias_th = 0.0
        self._lat_gate = 1.0
        self._dial = 0.0 if self._adaptive_floors else 1.0
        self._prev_cmd = (0.0, 0.0)
        self._prev_se2 = (0.0, 0.0, 0.0)
        if self._adaptive_floors:
            self._floor_est = adaptive.OnlineFloorEstimator(config)
        self._prev_scan = None
        self._prev2_scan = None
        # production: the fused tick (parity mode keeps the split path)
        self._fused: Optional[_FusedTick] = None
        if not config.parity_mode and config.fuse_online_tick:
            self._fused = _FusedTick(self, graph=graph and self.device.type == "cuda")

    # ------------------------------------------------------------ odometry
    def odometry(self, v: float, w: float, timestamp: float) -> tuple:
        """Control-command odometry (``robot.py:122-151``): mutually exclusive
        rotation/translation with the 0.6 simulator fudge on translation."""
        if self._prev_timestamp is None:
            dt = 0.0
        else:
            dt = timestamp - self._prev_timestamp
        self._prev_timestamp = timestamp
        if v != 0:
            return 0.0, v * dt * self.config.velocity_fudge
        return w * dt, 0.0

    # ---------------------------------------------------------- ICP proposal
    def _matches(self, cur, jobs):
        """Warm-started composite SE(2) matches ``src -> cur`` of every
        ``(src, src_valid, warm_ang, warm_t)`` job, in one batched ICP call.

        The warm start is computed on the host in float64 and cast to
        float32; rotations are elementwise (proposal/icp.py numerics note)."""
        pre = []
        for src, _, warm_ang, warm_t in jobs:
            ca, sa = np.cos(warm_ang), np.sin(warm_ang)
            pre.append(np.stack([ca * src[:, 0] - sa * src[:, 1],
                                 sa * src[:, 0] + ca * src[:, 1]], -1) + warm_t)
        k = len(jobs)
        dev = self.device
        res = icp_point_to_line(
            torch.from_numpy(np.stack(pre).astype(np.float32)).to(dev),
            torch.from_numpy(cur[0]).to(dev).expand(k, -1, -1),
            torch.from_numpy(np.stack([j[1] for j in jobs])).to(dev),
            torch.from_numpy(cur[1]).to(dev).expand(k, -1),
            self.config,
        )
        out = torch.cat([res.theta[:, None], res.translation], dim=1).cpu().numpy()
        matches = []
        for (_, _, warm_ang, warm_t), (th, tx, ty) in zip(jobs, out):
            th = float(th)
            ct, st = np.cos(th), np.sin(th)
            t = np.array([ct * warm_t[0] - st * warm_t[1],
                          st * warm_t[0] + ct * warm_t[1]]) \
                + np.array([tx, ty], np.float32)
            matches.append((warm_ang + th, t))
        return matches

    def icp_refine(self, points: np.ndarray, valid: np.ndarray,
                   rotation: float, translation: float, v: float):
        """Refine the command odometry with an ICP scan match between the
        previous and current scans, warm-started with the command odometry
        and converted back under the reference's rotation-XOR-translation
        convention (translating ticks take the signed along-track estimate).
        With fixed blending ``icp_blend`` interpolates command and match;
        with ``adaptive_proposal_floors`` the shared
        :class:`~fastslam_tpu_torch.proposal.adaptive.OnlineFloorEstimator`
        drives the blends, the proposal floors and the mode dial, read for
        this tick BEFORE its own residual is pushed.

        The single-step match and (adaptive floors) the direct two-step match
        scan(t-2) -> scan(t) share one batched ICP call."""
        cur = (np.asarray(points, np.float32), np.asarray(valid, bool))
        prev = self._prev_scan
        prev2 = self._prev2_scan
        self._prev2_scan = prev
        self._prev_scan = cur
        if prev is None:
            self._prev_cmd = (float(rotation), float(translation))
            if self._adaptive_floors:
                # first tick: no residual yet, but the step reads this tick
                # type's floors and dial from the estimator's prior
                k = int(v != 0)
                fxy, fth, a_xy, a_th, dial, d0 = self._floor_est.read(k)
                self._floor_xy, self._floor_th = fxy, fth
                self._blend_xy = a_xy
                self._blend_th = a_th
                self._bias_th = d0["b_th"]
                self._dial = dial
            return rotation, translation

        jobs = [(prev[0], prev[1], -rotation,
                 np.array([-translation, 0.0], np.float32))]
        two_step = self._adaptive_floors and prev2 is not None
        if two_step:
            rot_prev, trans_prev = self._prev_cmd
            cp, sp = np.cos(-rotation), np.sin(-rotation)
            warm2_t = np.array([cp * -trans_prev, sp * -trans_prev], np.float32) \
                + np.array([-translation, 0.0], np.float32)
            jobs.append((prev2[0], prev2[1], -(rot_prev + rotation), warm2_t))
        matches = self._matches(cur, jobs)
        ang, t_comp = matches[0]
        if v != 0:
            # signed along-track estimate: a perfect match gives
            # t_comp = (-trans, 0), so -t_comp[0] keeps the sign of a
            # slip-corrupted negative command
            icp_rot, icp_trans = 0.0, float(-t_comp[0])
        else:
            icp_rot, icp_trans = float(-ang), 0.0

        if self._adaptive_floors:
            k = int(v != 0)
            sr, al, la = adaptive.se2_residuals(
                np.array([ang], np.float32),
                np.array([t_comp], np.float32),
                np.array([0.0, rotation], np.float32),
                np.array([0.0, translation], np.float32),
            )
            kw = dict(sr_th=float(sr[1]), sr_al=float(al[1]), lat=float(la[1]))
            if two_step:
                dir_ang, dir_t = matches[1]
                pa, pt = self._prev_se2[0], self._prev_se2[1:]
                d_ang, d_t2 = adaptive.consistency_discrepancy(
                    np.array([pa, ang], np.float32),
                    np.array([pt, t_comp], np.float32),
                    np.array([dir_ang], np.float32),
                    np.array([dir_t], np.float32),
                )
                kw.update(d_ang=float(d_ang[0]), d_t2=float(d_t2[0]))
            self._prev_se2 = (ang, float(t_comp[0]), float(t_comp[1]))
            self._prev_cmd = (float(rotation), float(translation))
            # floors, blends and dial of THIS tick, read before its residual
            # is pushed (residuals through t-1, this tick's own type)
            fxy, fth, a_xy, a_th, dial, diag = self._floor_est.read(k)
            a_t = a_xy
            # the rotation blend is gated and uses the debiased match
            a_r = a_th
            if a_r and v == 0:
                icp_rot -= diag["b_th"]
            # match-failure gate: the lateral residual is pure matcher
            # error, so a failed match falls back to the command this tick
            if abs(float(t_comp[1])) > diag["lat_gate"]:
                a_t = a_r = 0.0
            self._floor_est.push(k, **kw)
            self._floor_xy, self._floor_th = fxy, fth
            self._blend_xy = a_xy
            self._blend_th = a_th
            self._bias_th = diag["b_th"]
            self._dial = dial
        else:
            self._prev_cmd = (float(rotation), float(translation))
            a_r = a_t = self.config.icp_blend
        return (
            (1.0 - a_r) * rotation + a_r * icp_rot,
            (1.0 - a_t) * translation + a_t * icp_trans,
        )

    # ------------------------------------------------------------- one tick
    def tick(self, points: np.ndarray, valid: np.ndarray, rotation: float,
             translation: float) -> np.ndarray:
        """Run perception (with ``track_corners``: corner extraction, the
        track update with this tick's odometry, the confirmed corners) and
        one filter step; returns the pose estimate the application should
        adopt (respecting the warmup gate)."""
        dev = self.device
        pts = torch.from_numpy(np.asarray(points, np.float32)).to(dev)
        vld = torch.from_numpy(np.asarray(valid, bool)).to(dev)
        if self._tracks is not None:
            self._tracks, ms = self._tracked_measurements(pts, vld, rotation, translation)
        else:
            ms = scan_to_measurements(pts, vld, self.config)
        draws = kernels.draw(self._generator, self.config.num_particles, fs2=self._fs2)
        extra = {}
        if self._adaptive_floors:
            extra = dict(proposal_floors=(_f32(self._floor_xy, dev),
                                          _f32(self._floor_th, dev)),
                         evidence_scale=_f32(self._dial, dev))
        self.state, est = kernels.fastslam_step_planes(
            self.state, rotation, translation, ms, self.config, draws, **extra)
        out = torch.cat([est, ms.valid.sum().to(est.dtype)[None]]).cpu().numpy()
        self._last_num_measurements = int(out[3])

        if self.iteration < self.config.warmup_iterations:
            # dead-reckon (jde_robots_main.py:41-49)
            self.robot[2] = (self.robot[2] + rotation + np.pi) % (2 * np.pi) - np.pi
            self.robot[0] += translation * np.cos(self.robot[2])
            self.robot[1] += translation * np.sin(self.robot[2])
            self.iteration += 1
        else:
            self.robot = out[:3].astype(float).copy()
        return self.robot.copy()

    def _tracked_measurements(self, pts, vld, rotation, translation):
        """The tracked frontend: extract corners, update the track table
        with the tick's odometry, measure the confirmed corners.  Returns
        ``(tracks, measurements)``."""
        cfg = self.config
        corners, cvalid = extract_corners(pts, vld, cfg)
        tracks = update_tracks(self._tracks, corners, cvalid, rotation, translation,
                               gate=cfg.track_gate, ema=cfg.track_ema,
                               max_misses=cfg.track_max_misses)
        pos, _ids, ok = stable_corners(tracks, min_hits=cfg.track_min_hits)
        return tracks, measurements_from_corners(pos, ok, cfg)

    def tick_fused(self, points: np.ndarray, valid: np.ndarray, rotation: float,
                   translation: float, v: float) -> np.ndarray:
        """The production tick, JAX's one-dispatch tick: the warm-started
        ICP refinement (with adaptive floors, the direct two-step match too),
        the frontend or corner tracking, and the filter step, in one piece
        of device work with one ``out[14]`` read back (:class:`_FusedTick`).

        The host's floor estimator reads this tick type's floors, blends,
        bias and gate before the tick and takes the tick's residuals after
        it.  The warmup dead-reckons with the refined odometry ``out[3:5]``.
        """
        k = int(v != 0)
        if self._adaptive_floors:
            # residuals through tick t-1, read at this tick's own type
            fxy, fth, a_xy, a_th, dial, diag = self._floor_est.read(k)
            self._floor_xy, self._floor_th = fxy, fth
            self._blend_xy = a_xy
            self._blend_th = a_th
            self._bias_th = diag["b_th"]
            self._lat_gate = diag["lat_gate"]
            self._dial = dial
        rot_prev, trans_prev = self._prev_cmd
        self._prev_cmd = (float(rotation), float(translation))
        has_prev, has_prev2 = self._fused.has_prev()
        out = self._fused(points, valid, (
            rotation, translation, rot_prev, trans_prev, float(v != 0),
            float(has_prev), float(has_prev2), self._floor_xy, self._floor_th,
            self._blend_xy, self._blend_th, self._bias_th, self._lat_gate, self._dial))
        self._last_num_measurements = int(out[5])
        self._last_out = out
        if self._adaptive_floors:
            # this tick's residuals; the next tick reads at its own type
            ang, tx, ty = float(out[8]), float(out[9]), float(out[10])
            kw = {}
            if has_prev:
                sr, al, la = adaptive.se2_residuals(
                    np.array([ang], np.float32), np.array([[tx, ty]], np.float32),
                    np.array([0.0, rotation], np.float32),
                    np.array([0.0, translation], np.float32))
                kw.update(sr_th=float(sr[1]), sr_al=float(al[1]), lat=float(la[1]))
            if has_prev2:
                pa, ptx, pty = self._prev_se2
                d_ang, d_t2 = adaptive.consistency_discrepancy(
                    np.array([pa, ang], np.float32),
                    np.array([[ptx, pty], [tx, ty]], np.float32),
                    np.array([out[11]], np.float32),
                    np.array([[out[12], out[13]]], np.float32))
                kw.update(d_ang=float(d_ang[0]), d_t2=float(d_t2[0]))
            self._prev_se2 = (ang, tx, ty)
            self._floor_est.push(k, **kw)

        if self.iteration < self.config.warmup_iterations:
            rot_u, trans_u = float(out[3]), float(out[4])
            self.robot[2] = (self.robot[2] + rot_u + np.pi) % (2 * np.pi) - np.pi
            self.robot[0] += trans_u * np.cos(self.robot[2])
            self.robot[1] += trans_u * np.sin(self.robot[2])
            self.iteration += 1
        else:
            self.robot = out[:3].astype(float).copy()
        return self.robot.copy()

    def state_blocks(self) -> FilterState:
        """The filter state in the ``[P, L, k]`` blocks layout, for the health
        monitor, the global map and checkpoints (a transposed copy)."""
        return from_planes(self.state)

    def set_state_blocks(self, state: FilterState) -> None:
        """Install a blocks-layout state (after a health recovery).  The
        fused tick's state is a set of static buffers that its CUDA graph
        reads and writes, so there the new state is copied into them."""
        planes = to_planes(state, self.config)
        if self._fused is None:
            self.state = planes
            return
        for name, dst in self.state.__dict__.items():
            if dst is not None:
                dst.copy_(getattr(planes, name))

    def set_generator(self, generator: torch.Generator) -> None:
        """Continue the filter's draws from ``generator``'s stream (after a
        recovery from a checkpoint): its state is copied into the runner's
        own generator."""
        self._generator.set_state(generator.get_state())


class _FusedTick:
    """The fused online tick of a :class:`SLAMRunner` (JAX's
    ``_build_fused_tick``, ``fastslam_tpu/app/runner.py``).

    Everything the tick reads or writes lives in static tensors: the filter
    state, the track table, the scans t-1 and t-2, the tick's draws and one
    input row holding the scan t, its validity and the fourteen host scalars
    (odometry, previous command, ``v_active``, ``has_prev``, ``has_prev2``,
    floors, blends, bias, lateral gate, dial).  :meth:`_body` reads them and
    writes the new state, tracks and scans back into them, and returns
    ``out[14] = [est_x, est_y, est_yaw, rot_used, trans_used, n_meas,
    floor_xy, floor_th, ang, t_x, t_y, dir_ang, dir_tx, dir_ty]``.

    On CUDA the first tick runs the body eagerly (it builds the kernels and
    initializes every lazy resource), then the body is captured once into a
    :class:`torch.cuda.CUDAGraph`; every later tick is one replay.  The draws
    are taken eagerly from the runner's generator before each tick and
    copied into the static draw tensors, so a replay takes exactly the draws
    of the eager tick.  Kernel launches are counted per replay: the capture
    records the wrappers' counts and takes them back (it launches nothing),
    and each replay adds them.  On the CPU, or with ``graph=False``, the
    body runs eagerly every tick.  A capture that fails raises; nothing
    falls back to the eager or the split path.
    """

    N_SCALARS = 14

    def __init__(self, runner: SLAMRunner, *, graph: bool):
        self.runner = runner
        self.config = runner.config
        self.graph_enabled = graph
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self._tally: dict = {}
        self._inp = None
        self._ticks = 0
        self._icp = self.config.use_icp_proposal
        self._floors_on = runner._adaptive_floors

    def has_prev(self):
        """Whether the scans t-1 and t-2 exist at the coming tick."""
        if not self._icp:
            return False, False
        return self._ticks >= 1, self._ticks >= 2

    # ------------------------------------------------------------ buffers
    def _allocate(self, n: int) -> None:
        dev = self.runner.device
        width = 3 * n + self.N_SCALARS
        self._n = n
        self._inp = torch.zeros(width, dtype=torch.float32, device=dev)
        self._host = torch.zeros(width, dtype=torch.float32,
                                 pin_memory=dev.type == "cuda")
        self._prev = (torch.zeros((n, 2), dtype=torch.float32, device=dev),
                      torch.zeros(n, dtype=torch.bool, device=dev))
        self._prev2 = (torch.zeros((n, 2), dtype=torch.float32, device=dev),
                       torch.zeros(n, dtype=torch.bool, device=dev))
        p = self.config.num_particles
        normal = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
        fs2 = self.runner._fs2
        self._draws = kernels.Draws(rot=None if fs2 else normal(p),
                                    trans=None if fs2 else normal(p), u0=normal(),
                                    noise=normal(p, 3) if fs2 else None)

    def _fill(self, points, valid, scalars) -> None:
        n = self._n
        host = self._host.numpy()
        host[:2 * n] = np.asarray(points, np.float32).reshape(-1)
        host[2 * n:3 * n] = np.asarray(valid, bool)
        host[3 * n:] = np.asarray(scalars, np.float64).astype(np.float32)
        self._inp.copy_(self._host, non_blocking=True)
        draws = kernels.draw(self.runner._generator, self.config.num_particles,
                             fs2=self.runner._fs2)
        for dst, src in zip(self._draws, draws):
            if dst is not None:
                dst.copy_(src)

    # --------------------------------------------------------------- body
    def _body(self) -> torch.Tensor:
        """One fused tick on the static tensors; returns ``out[14]``."""
        cfg, runner, n = self.config, self.runner, self._n
        dev = runner.device
        pts = self._inp[:2 * n].view(n, 2)
        vld = self._inp[2 * n:3 * n] > 0.5
        (rotation, translation, rot_prev, trans_prev, v_active, has_prev, has_prev2,
         fxy, fth, a_xy, a_th, b_th, lat_gate, dial) = self._inp[3 * n:].unbind()
        v_active, has_prev, has_prev2 = v_active > 0.5, has_prev > 0.5, has_prev2 > 0.5
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        ang, t_comp = zero, torch.zeros(2, dtype=torch.float32, device=dev)
        dir_ang, dir_t = zero, torch.zeros(2, dtype=torch.float32, device=dev)
        if self._icp:
            # a missing scan falls back to the current one, masked by has_prev
            prev_pts = torch.where(has_prev, self._prev[0], pts)
            prev_vld = torch.where(has_prev, self._prev[1], vld)
            # warm start with the command odometry, rotated elementwise
            pre = rotate_points(prev_pts, -rotation) - torch.stack([translation, zero])
            srcs, src_vld = [pre], [prev_vld]
            if self._floors_on:
                # the direct two-step match scan(t-2) -> scan(t) calibrates
                # the matcher's own noise for the host estimator
                prev2_pts = torch.where(has_prev2, self._prev2[0], pts)
                prev2_vld = torch.where(has_prev2, self._prev2[1], vld)
                warm2_ang = -(rot_prev + rotation)
                warm2_t = (rotate_points(torch.stack([-trans_prev, zero]), -rotation)
                           + torch.stack([-translation, zero]))
                srcs.append(rotate_points(prev2_pts, warm2_ang) + warm2_t)
                src_vld.append(prev2_vld)
            # both matches in one batched call: one fused ICP launch
            k = len(srcs)
            res = icp_point_to_line(torch.stack(srcs), pts.expand(k, n, 2),
                                    torch.stack(src_vld), vld.expand(k, n), cfg)
            ang = res.theta[0] - rotation
            t_comp = (rotate_points(torch.stack([-translation, zero]), res.theta[0])
                      + res.translation[0])
            # signed along-track estimate; the rotation match debiased by b_th
            icp_trans = torch.where(v_active, -t_comp[0], 0.0)
            icp_rot = torch.where(v_active, 0.0, -ang - b_th)
            if self._floors_on:
                dir_ang = warm2_ang + res.theta[1]
                dir_t = rotate_points(warm2_t, res.theta[1]) + res.translation[1]
                # match-failure gate: |lateral residual| > lat_gate fails the
                # match (the port's one rule on both paths; JAX's fused tick
                # fails on >=, its split path on >)
                match_ok = (torch.abs(t_comp[1]) <= lat_gate).to(torch.float32)
                a_r = a_th * match_ok
                a_t = a_xy * match_ok
            else:
                a_r = a_t = torch.full((), cfg.icp_blend, dtype=torch.float32, device=dev)
            rotation = torch.where(has_prev, (1 - a_r) * rotation + a_r * icp_rot, rotation)
            translation = torch.where(has_prev, (1 - a_t) * translation + a_t * icp_trans,
                                      translation)
            self._prev2[0].copy_(self._prev[0])
            self._prev2[1].copy_(self._prev[1])
            self._prev[0].copy_(pts)
            self._prev[1].copy_(vld)
        if runner._tracks is not None:
            tracks, ms = runner._tracked_measurements(pts, vld, rotation, translation)
            for dst, src in zip(runner._tracks, tracks):
                dst.copy_(src)
        else:
            ms = scan_to_measurements(pts, vld, cfg)
        extra = {}
        if self._floors_on:
            extra = dict(proposal_floors=(fxy, fth), evidence_scale=dial)
        state, est = kernels.fastslam_step_planes(
            runner.state, rotation, translation, ms, cfg, self._draws, on_device=True,
            **extra)
        for name, dst in runner.state.__dict__.items():
            if dst is not None:
                dst.copy_(getattr(state, name))
        n_meas = ms.valid.sum().to(torch.float32)
        return torch.cat([est, torch.stack([rotation, translation, n_meas, fxy, fth, ang,
                                            t_comp[0], t_comp[1], dir_ang, dir_t[0],
                                            dir_t[1]])])

    # --------------------------------------------------------------- tick
    def __call__(self, points, valid, scalars) -> np.ndarray:
        n = np.asarray(points).shape[0]
        if self._inp is None:
            self._allocate(n)
        elif n != self._n:
            raise ValueError(f"the fused tick's buffers hold scans of {self._n} beams, "
                             f"got {n}")
        self._fill(points, valid, scalars)
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            for name, count in self._tally.items():
                cuda_kernels.LAUNCHES[name] += count
            out = self._out
        else:
            out = self._body()
            if self.graph_enabled:
                self._capture()
        self._ticks += 1
        return out.cpu().numpy()

    def _capture(self) -> None:
        """Capture the body into a CUDA graph (after the eager first tick)."""
        before = dict(cuda_kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.runner.device), torch.cuda.graph(graph):
            self._out = self._body()
        # the capture launched nothing: take its counts back for the replays
        self._tally = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before
                       if cuda_kernels.LAUNCHES[k] != before[k]}
        for name, count in self._tally.items():
            cuda_kernels.LAUNCHES[name] -= count
        self.graph = graph


def run_driver(
    driver,
    config: FastSLAMConfig,
    max_ticks: int = 10_000,
    rng: int = 0,
    *,
    device: torch.device | str = "cuda",
    graph: bool = True,
    serialize_path: Optional[str] = None,
    serialize_every: int = 1,
    metrics_path: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 200,
    health: bool = False,
    odometry_noise: tuple = (0.0, 0.0),
    odometry_noise_seed: int = 123,
) -> RunHistory:
    """Drive the online loop against any driver until it is exhausted.

    ``odometry_noise`` = (rotation, translation) std-devs of wheel slip added
    to what the filter sees, one draw per active component tick; ground truth
    is unaffected.

    The production hooks, all off by default, run after each tick's filter
    step in this order: the health check (``health``), with a recovery from
    ``checkpoint_path`` or a re-initialization when the state is no longer
    finite; a ``tick`` record in the JSONL ``metrics_path`` (and a ``health``
    record for each failed check); a viewer snapshot at ``serialize_path``
    every ``serialize_every`` ticks (the global map of
    :func:`~fastslam_tpu_torch.frontend.global_map.cluster_known_landmarks`);
    a checkpoint of the blocks-layout state at ``checkpoint_path`` every
    ``checkpoint_every`` ticks from tick ``checkpoint_every`` on.  The hooks
    read the state and draw nothing, so they leave the estimates as they
    are; with every hook off the loop adds no synchronization.

    In production mode with ``fuse_online_tick`` (the default) every tick is
    :meth:`SLAMRunner.tick_fused`, on CUDA one replay of its captured graph;
    ``graph=False`` runs that tick eagerly on the card instead (the
    reference the graph is held against).  Otherwise each tick is the split
    path.
    """
    runner = SLAMRunner(config, rng, device=device, graph=graph)
    history = RunHistory()
    odo_rng = np.random.default_rng(odometry_noise_seed)
    monitor = HealthMonitor(config) if health else None
    metrics = MetricsLog(metrics_path) if metrics_path else None

    # the filter's world frame is the robot's start pose: ground truth maps
    # through the full SE(2) inverse of the start pose
    p0 = driver.get_pose()
    off = np.array([p0.x, p0.y, p0.yaw])
    c0, s0 = np.cos(-off[2]), np.sin(-off[2])

    running = True
    ticks = 0
    prev_cmd = (0.0, 0.0)
    spent = history.stage_seconds
    fused = runner._fused is not None
    spent.update({"tick": 0.0} if fused else {"icp_refine": 0.0, "tick": 0.0})
    hook_time = PhaseTimer()   # each hook ends in a host copy or a file write
    while running and ticks < max_ticks:
        scan = driver.get_laser()
        points, valid = scan.to_points()

        if hasattr(driver, "commanded_velocity"):
            cur_cmd = driver.commanded_velocity()
        else:  # live policy (robot.py:61-88)
            bumper = driver.get_bumper()
            if bumper.state == 1:
                cur_cmd = (0.0, config.angular_velocity if bumper.bumper == 0
                           else -config.angular_velocity)
            else:
                cur_cmd = (config.linear_velocity, 0.0)
            driver.set_velocity(*cur_cmd)

        # the scan at tick t reflects motion driven by tick t-1's commands
        v, w = prev_cmd
        prev_cmd = cur_cmd
        rotation, translation = runner.odometry(v, w, scan.timestamp)
        if odometry_noise != (0.0, 0.0):
            if rotation != 0.0:
                rotation += odo_rng.normal(0.0, odometry_noise[0])
            if translation != 0.0:
                translation += odo_rng.normal(0.0, odometry_noise[1])
        t0 = time.perf_counter()
        if fused:
            est = runner.tick_fused(points, valid, rotation, translation, v)
            spent["tick"] += time.perf_counter() - t0
        else:
            if config.use_icp_proposal:
                rotation, translation = runner.icp_refine(points, valid, rotation,
                                                          translation, v)
            t1 = time.perf_counter()
            est = runner.tick(points, valid, rotation, translation)
            spent["icp_refine"] += t1 - t0
            spent["tick"] += time.perf_counter() - t1

        gp = driver.get_pose()
        dx, dy = gp.x - off[0], gp.y - off[1]
        gt = np.array([c0 * dx - s0 * dy, s0 * dx + c0 * dy,
                       (gp.yaw - off[2] + np.pi) % (2 * np.pi) - np.pi])
        history.est_poses.append(est)
        history.gt_poses.append(gt)
        ev = evaluate_tick(gt, est)
        history.evaluations.append(ev)
        history.num_measurements.append(runner._last_num_measurements)

        if monitor is not None:
            with hook_time.phase("health"):
                rep = monitor.check(runner.state, est)
                if not rep.ok:
                    if metrics:
                        metrics.write("health", tick=ticks, issues=rep.issues)
                    if "nan_or_inf_state" in rep.issues:
                        state, generator = monitor.recover(
                            runner.state, est, checkpoint_path=checkpoint_path)
                        runner.set_state_blocks(state)
                        if generator is not None:   # the checkpoint's stream
                            runner.set_generator(generator)
        if metrics:
            with hook_time.phase("metrics"):
                metrics.write("tick", tick=ticks, distance=ev.distance,
                              num_measurements=runner._last_num_measurements)
        if serialize_path and ticks % serialize_every == 0:
            with hook_time.phase("serialize"):
                cents, ok = cluster_known_landmarks(runner.state_blocks(), config)
                cents, ok = cents.cpu().numpy(), ok.cpu().numpy()
                serialize_tick(est, gt, runner.state.poses.cpu().numpy(),
                               [tuple(map(float, c)) for c in cents[ok]],
                               ev.to_dict(), path=serialize_path)
        if checkpoint_path and ticks and ticks % checkpoint_every == 0:
            with hook_time.phase("checkpoint"):
                save_checkpoint(checkpoint_path, runner.state_blocks(), iteration=ticks,
                                robot_pose=runner.robot, generator=runner._generator)

        running = driver.step()
        ticks += 1

    if metrics:
        metrics.close()
    spent.update(hook_time.totals)
    if fused:
        history.graph_replays = runner._fused.replays
    if runner._adaptive_floors:
        history.final_floors = (runner._floor_xy, runner._floor_th)
        r0 = runner._floor_est.read(0)
        r1 = runner._floor_est.read(1)
        history.final_floors_by_type = ((r0[0], r0[1]), (r1[0], r1[1]))
    return history


# ---------------------------------------------------------------------------
# offline batch replay
# ---------------------------------------------------------------------------

def scan_points(log):
    """Polar scans ``[T, B]`` -> robot-frame points ``[T, B, 2]`` and validity."""
    values = np.asarray(log.scans, np.float32)
    n = values.shape[1]
    angles = np.radians(np.arange(n) - n // 2).astype(np.float32)
    valid = (values >= log.min_range) & (values <= log.max_range)
    pts = np.stack([values * np.cos(angles), values * np.sin(angles)], axis=-1)
    pts[~valid] = 0.0
    return pts, valid


def odometry(log, config: FastSLAMConfig):
    """Per-tick (rotation, translation) from the previous tick's commands,
    rotation XOR translation, with the velocity fudge on translation."""
    t_total = len(log)
    rots = np.zeros(t_total, np.float32)
    trans = np.zeros(t_total, np.float32)
    prev_ts = None
    prev_cmd = (0.0, 0.0)
    for t in range(t_total):
        v, w = prev_cmd
        prev_cmd = (float(log.cmd_v[t]), float(log.cmd_w[t]))
        ts = float(log.timestamps[t])
        dt = 0.0 if prev_ts is None else ts - prev_ts
        prev_ts = ts
        if v != 0:
            trans[t] = v * dt * config.velocity_fudge
        else:
            rots[t] = w * dt
    return rots, trans


class ICPOdometry(NamedTuple):
    """What the batched ICP stage hands the filter, per tick of the log."""

    rots: np.ndarray                  # [T] float32 blended rotation odometry
    trans: np.ndarray                 # [T] float32 blended translation odometry
    floors_xy: Optional[np.ndarray]   # [T] adaptive xy floors, None if fixed
    floors_th: Optional[np.ndarray]   # [T] adaptive theta floors
    dial: Optional[np.ndarray]        # [T] fs2 mode dial


def icp_stage_pairs(pts: torch.Tensor, valid: torch.Tensor, rots: np.ndarray,
                    trans: np.ndarray, two_step: bool):
    """The cloud pairs of the batched ICP stage, warm-started with the
    command odometry: the T-1 single-step pairs scan(t-1) -> scan(t), then
    (``two_step``) the T-2 direct pairs scan(t-2) -> scan(t).

    Returns ``(pre [B, N, 2], target [B, N, 2], source_valid [B, N],
    target_valid [B, N], warm_ang [B], warm_t [B, 2])``: ``pre`` is the
    source moved by the warm start ``(warm_ang, warm_t)``, rotated
    elementwise."""
    dev = pts.device
    rots_d = torch.from_numpy(rots).to(dev)
    trans_d = torch.from_numpy(trans).to(dev)
    zeros = torch.zeros(len(rots), dtype=torch.float32, device=dev)
    srcs, tgts, svs, tvs = [pts[:-1]], [pts[1:]], [valid[:-1]], [valid[1:]]
    warm_ang = [-rots_d[1:]]
    warm_t = [torch.stack([-trans_d[1:], zeros[1:]], dim=-1)]
    if two_step:
        # the direct two-step match calibrates the matcher's own noise: the
        # true motion cancels against the composition of the two single steps
        srcs.append(pts[:-2])
        tgts.append(pts[2:])
        svs.append(valid[:-2])
        tvs.append(valid[2:])
        warm_ang.append(-(rots_d[1:-1] + rots_d[2:]))
        warm_t.append(rotate_points(torch.stack([-trans_d[1:-1], zeros[2:]], dim=-1),
                                    -rots_d[2:])
                      + torch.stack([-trans_d[2:], zeros[2:]], dim=-1))
    src, warm_ang, warm_t = torch.cat(srcs), torch.cat(warm_ang), torch.cat(warm_t)
    pre = rotate_points(src, warm_ang[:, None]) + warm_t[:, None, :]
    return pre, torch.cat(tgts), torch.cat(svs), torch.cat(tvs), warm_ang, warm_t


def icp_floor_stage(pts: torch.Tensor, valid: torch.Tensor, rots: np.ndarray,
                    trans: np.ndarray, v_active: np.ndarray,
                    config: FastSLAMConfig) -> ICPOdometry:
    """The ICP refinement of a whole log's odometry, and its adaptive floors.

    ``pts [T, B, 2]`` and ``valid [T, B]`` on the device; ``rots``/``trans``
    the command odometry the filter would see (slip included), ``v_active``
    whether each tick translates.  The warm start uses the command odometry,
    never the filter estimate, so all T-1 single-step matches (and with
    adaptive floors the T-2 direct two-step matches) run as one batched ICP
    call in float32 on the device (:func:`icp_stage_pairs`).  The floor
    schedule is a host recurrence over the residuals; the debias, the
    match-failure gate ``|lat| > lat_gate`` and the blends follow the JAX
    replay exactly.
    """
    t_total = len(rots)
    floors_on = config.adaptive_proposal_floors
    two_step = floors_on and t_total >= 3
    pre, tgt, sv, tv, warm_ang, warm_t = icp_stage_pairs(pts, valid, rots, trans,
                                                         two_step)
    res = icp_point_to_line(pre, tgt, sv, tv, config)
    # composite SE(2) of each match: angle addition, elementwise rotation
    ang = (warm_ang + res.theta).cpu().numpy()
    t_comp = (rotate_points(warm_t, res.theta) + res.translation).cpu().numpy()
    angs, tvecs = ang[:t_total - 1], t_comp[:t_total - 1]
    va = v_active[1:]
    # signed along-track estimate on translation ticks
    icp_rots = np.concatenate([[0.0], np.where(va, 0.0, -angs).astype(np.float32)])
    icp_trs = np.concatenate([[0.0], np.where(va, -tvecs[:, 0], 0.0).astype(np.float32)])

    floors_xy = floors_th = dial = None
    if floors_on:
        d_ang = d_t2 = None
        if two_step:
            d_ang, d_t2 = adaptive.consistency_discrepancy(
                angs, tvecs, ang[t_total - 1:], t_comp[t_total - 1:])
        sr_th, sr_al, lat = adaptive.se2_residuals(angs, tvecs, rots, trans)
        sched = adaptive.floor_schedule(sr_th, sr_al, lat, d_ang, d_t2, v_active,
                                        config)
        floors_xy, floors_th, dial = sched.floors_xy, sched.floors_th, sched.dial
        a_r, a_t = sched.blend_th, sched.blend_xy
        # the rotation blend is gated and consumes the debiased match
        icp_rots = np.where(v_active, icp_rots,
                            icp_rots - sched.bias_th).astype(np.float32)
        # match-failure gate: zero this tick's blends on a failed match
        bad = np.abs(lat) > sched.lat_gate
        a_r = np.where(bad, 0.0, a_r).astype(np.float32)
        a_t = np.where(bad, 0.0, a_t).astype(np.float32)
    else:
        a_r = a_t = np.full(t_total, config.icp_blend, np.float32)
    blend = np.arange(t_total) > 0  # tick 0 has no previous scan
    rots = np.where(blend, (1 - a_r) * rots + a_r * icp_rots, rots).astype(np.float32)
    trans = np.where(blend, (1 - a_t) * trans + a_t * icp_trs, trans).astype(np.float32)
    return ICPOdometry(rots, trans, floors_xy, floors_th, dial)


def replay_chunked(log, config: FastSLAMConfig, chunk_size: int = 8,
                   rng: int = 0, *, device: torch.device | str = "cuda",
                   odometry_noise: tuple = (0.0, 0.0),
                   odometry_noise_seed: int = 123) -> RunHistory:
    """Replay ``log`` through the chunked engine on ``device`` (production
    mode), with the motion or the FastSLAM 2.0 proposal, and optionally the
    ICP refinement of the odometry (``use_icp_proposal``) with adaptive
    floors and mode dial (``adaptive_proposal_floors``), whose per-tick
    ``[C]`` rows feed the fs2 prior of each chunk.

    ``rng`` seeds the :class:`torch.Generator` of the filter's draws.
    ``odometry_noise`` = (rotation, translation) std-devs of wheel slip added
    to what the filter sees, one draw per active component tick, before the
    ICP refinement, so the scan match must recover it.
    """
    if config.parity_mode:
        raise ValueError("replay_chunked runs in production mode "
                         "(parity_mode=False)")
    device = torch.device(device)
    t_total = len(log)
    c = chunk_size

    pts, valid = scan_points(log)
    pts_d = torch.from_numpy(pts).to(device)
    valid_d = torch.from_numpy(valid).to(device)
    ms = [scan_to_measurements(pts_d[t], valid_d[t], config) for t in range(t_total)]
    rb = torch.stack([m.range_bearing for m in ms])          # [T, M, 2]
    mv = torch.stack([m.valid for m in ms])                  # [T, M]

    rots, trans = odometry(log, config)
    v_active = np.concatenate([[False], np.asarray(log.cmd_v[:-1], np.float64) != 0])
    if odometry_noise != (0.0, 0.0):
        odo_rng = np.random.default_rng(odometry_noise_seed)
        for t in range(t_total):
            if rots[t] != 0.0:
                rots[t] += odo_rng.normal(0.0, odometry_noise[0])
            if trans[t] != 0.0:
                trans[t] += odo_rng.normal(0.0, odometry_noise[1])

    floors = None
    if config.use_icp_proposal:
        stage = icp_floor_stage(pts_d, valid_d, rots, trans, v_active, config)
        rots, trans = stage.rots, stage.trans
        if stage.floors_xy is not None:
            floors = [torch.from_numpy(a).to(device)
                      for a in (stage.floors_xy, stage.floors_th, stage.dial)]
    rots_d = torch.from_numpy(rots).to(device)
    trans_d = torch.from_numpy(trans).to(device)

    def extra(sl):
        if floors is None:
            return {}
        fxy, fth, dial = (f[sl] for f in floors)
        return dict(proposal_floors=(fxy, fth), evidence_scale=dial)

    generator = torch.Generator(device=device).manual_seed(rng)
    state = init_planes_state(config, device)
    p = config.num_particles
    fs2 = kernels.uses_fs2(config)
    n_chunks = t_total // c
    est = torch.zeros((t_total, 3), dtype=torch.float32, device=device)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        state, est[sl] = kernels.fastslam_steps_planes_chunked(
            state, rots_d[sl], trans_d[sl], Measurements(rb[sl], mv[sl]),
            config, kernels.draw(generator, p, c, fs2=fs2), **extra(sl),
        )
    for t in range(n_chunks * c, t_total):
        state, est[t] = kernels.fastslam_step_planes(
            state, rots_d[t], trans_d[t], Measurements(rb[t], mv[t]), config,
            kernels.draw(generator, p, fs2=fs2), **extra(t),
        )
    est = est.cpu().numpy()

    # warmup gate: dead-reckon exactly as the online loop
    robot = np.zeros(3)
    for t in range(min(config.warmup_iterations, t_total)):
        robot[2] = (robot[2] + rots[t] + np.pi) % (2 * np.pi) - np.pi
        robot[0] += trans[t] * np.cos(robot[2])
        robot[1] += trans[t] * np.sin(robot[2])
        est[t] = robot

    # ground truth in the filter's start frame
    gts = np.asarray(log.gt_poses, np.float64)
    off = gts[0]
    c0, s0 = np.cos(-off[2]), np.sin(-off[2])
    dx, dy = gts[:, 0] - off[0], gts[:, 1] - off[1]
    gt = np.stack(
        [c0 * dx - s0 * dy, s0 * dx + c0 * dy,
         (gts[:, 2] - off[2] + np.pi) % (2 * np.pi) - np.pi], axis=-1,
    )

    history = RunHistory()
    history.est_poses = [e for e in est]
    history.gt_poses = [g for g in gt]
    history.num_measurements = [int(x) for x in mv.sum(dim=1).tolist()]
    if floors is not None:
        history.final_floors = (float(stage.floors_xy[-1]), float(stage.floors_th[-1]))
        history.floor_traj = (stage.floors_xy.copy(), stage.floors_th.copy())
    for e, g in zip(est, gt):
        history.evaluations.append(evaluate_tick(g, e))
    return history
