"""Online traffic: one robot replaying a recorded drive through the
program's production loop, one scan at a time.

Set-up records the drive from the seed (``drive.py``), builds the
program's ``SLAMRunner`` and runs the drive's first ``warmup_ticks``
ticks: the first builds the kernels and captures the fused tick's CUDA
graph, the rest replay it.  The window hands over the next scan when the
last tick has returned (a closed loop): ``SLAMRunner.odometry`` on the
previous tick's command, the drive's wheel slip on the active component,
then ``SLAMRunner.tick_fused``, as ``app/runner.py:run_driver`` calls them
with its hooks off.  Each tick's latency runs from handing the scan over
to the return of the pose.  A drive that ends before the window does is a
failure.

The check follows the program's own state: before the ticks the seed
draws (one in each bucket of ``check_buckets`` that the window reaches)
the harness copies the filter state, the scans t-1 and t-2 (into copies
made in set-up), the floor estimator's windows and the loop's host state;
after them, the state, the tick's draws, its ``out`` row, the returned
pose and the estimator.
Once the window has closed, the plain reference (``reference/online.py``)
runs each sampled tick from the copies and the drive.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from benchmark import drive as drives
from benchmark import harness
from benchmark import trace as tracing
from benchmark.reference import filter as rf
from benchmark.reference import online as ro

ESTIMATOR_WINDOWS = ro.FloorEstimator.NAMES


def program_config(cell: harness.Cell, overrides: dict | None = None):
    from fastslam_tpu_torch.config import FastSLAMConfig

    return FastSLAMConfig(**{**cell.config["program"], **(overrides or {})})


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all values, by linear interpolation
    between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


class OnlineRun:
    """One run of an online cell on ``device``; ``overrides`` change the
    program's configuration (tests run tiny sizes on the CPU)."""

    def __init__(self, cell: harness.Cell, seed: int, device, *, overrides=None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.cfg = program_config(cell, overrides)
        self.ref_cfg = ro.namespace({**cell.config["program"], **(overrides or {})})
        t = cell.traffic
        self.warmup = int(t["warmup_ticks"])
        buckets = t["check_buckets"]
        rng = np.random.default_rng(seed)
        self.samples = [self.warmup + int(rng.integers(a, b))
                        for a, b in zip(buckets[:-1], buckets[1:])]
        self.snaps = {}

    def setup(self, seconds: float) -> None:
        from fastslam_tpu_torch.app.runner import SLAMRunner
        from fastslam_tpu_torch.core import kernels

        t = self.cell.traffic
        ticks = self.warmup + int(np.ceil(seconds * t["drive_frames_per_s"]))
        self.drive = drives.record(t, self.seed, ticks)
        harness.log_setup(f"drive of {ticks} ticks")
        self.fs2 = kernels.uses_fs2(self.cfg)
        self.runner = SLAMRunner(self.cfg, rng=self.seed % 2 ** 63, device=self.device)
        self.prev_cmd = (0.0, 0.0)
        self.t = 0
        harness.log_setup("runner")
        for _ in range(self.warmup):
            self.tick()
        # the sampled ticks' copies, made here so the window allocates nothing
        draws = {k: v for k, v in self.runner._fused._draws._asdict().items() if v is not None}
        for i in self.samples:
            self.snaps[i] = {"before": self.device_copies(), "after": self.device_copies(),
                             "draws": {k: v.clone() for k, v in draws.items()}}
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # --------------------------------------------------------------- a tick
    def tick(self):
        """Hand over the next scan; returns the seconds until the pose came
        back."""
        d, i, runner = self.drive, self.t, self.runner
        t0 = time.perf_counter()
        v, w = self.prev_cmd
        rotation, translation = runner.odometry(v, w, float(d.timestamps[i]))
        if rotation != 0.0:
            rotation += float(d.slip_rot[i])
        if translation != 0.0:
            translation += float(d.slip_trans[i])
        pose = runner.tick_fused(d.points[i], d.valid[i], rotation, translation, v)
        dt = time.perf_counter() - t0
        self.prev_cmd = (float(d.cmd_v[i]), float(d.cmd_w[i]))
        self.t += 1
        return dt, pose

    def device_copies(self) -> dict:
        """Copies of the runner's device state: the filter state and the
        scans t-1 and t-2."""
        r = self.runner
        return {"state": {k: getattr(r.state, k).clone() for k in rf.FIELDS},
                "prev": tuple(x.clone() for x in r._fused._prev),
                "prev2": tuple(x.clone() for x in r._fused._prev2)}

    def program_state(self, into: dict) -> dict:
        """The runner's state that the next tick reads or writes, copied
        into ``into`` (made by :meth:`device_copies`)."""
        r = self.runner
        fused = r._fused
        for k in rf.FIELDS:
            into["state"][k].copy_(getattr(r.state, k))
        for dst, src in zip(into["prev"] + into["prev2"], fused._prev + fused._prev2):
            dst.copy_(src)
        into.update(ticks=fused._ticks, prev_cmd=r._prev_cmd, prev_se2=r._prev_se2,
                    iteration=r.iteration, robot=r.robot.copy())
        if r._adaptive_floors:
            est = r._floor_est
            into["windows"] = {n: copy.deepcopy(getattr(est, n).w) for n in ESTIMATOR_WINDOWS}
        return into

    def window(self, seconds: float, trace: bool) -> dict:
        phase = tracing.phases(trace)
        latencies, failed = [], 0
        with tracing.profiled(trace) as prof:
            with phase(tracing.WINDOW):
                start = time.perf_counter()
                while time.perf_counter() - start < seconds:
                    if self.t >= len(self.drive):
                        failed = 1
                        break
                    snap = self.snaps.get(self.t)
                    if snap is not None:
                        with phase("bench.snapshot"):
                            self.program_state(snap["before"])
                    with phase("bench.tick"):
                        dt, pose = self.tick()
                    latencies.append(dt)
                    if snap is not None:
                        with phase("bench.snapshot"):
                            self.program_state(snap["after"])
                            for k, v in snap["draws"].items():
                                v.copy_(getattr(self.runner._fused._draws, k))
                            snap.update(out=self.runner._last_out.copy(),
                                        pose=np.asarray(pose, np.float64))
                if self.cuda:
                    torch.cuda.synchronize(self.device)
                end = time.perf_counter()
        out = {"latencies": latencies, "seconds": end - start, "failed": failed}
        if trace:
            out["trace"] = tracing.summarize(tracing.events(prof))
        return out

    def free(self) -> None:
        self.runner = None
        if self.cuda:
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- check
    def ref_odometry(self, i: int) -> tuple:
        """Tick ``i``'s odometry from the previous tick's command, rotation
        XOR translation, the translation scaled by the velocity fudge, the
        slip on the active component: ``(rotation, translation, v)``."""
        d = self.drive
        if i == 0:
            return 0.0, 0.0, 0.0
        v, w = float(d.cmd_v[i - 1]), float(d.cmd_w[i - 1])
        dt = float(d.timestamps[i]) - float(d.timestamps[i - 1])
        rotation, translation = ((0.0, v * dt * self.ref_cfg.velocity_fudge) if v != 0
                                 else (w * dt, 0.0))
        if rotation != 0.0:
            rotation += float(d.slip_rot[i])
        if translation != 0.0:
            translation += float(d.slip_trans[i])
        return rotation, translation, v

    def scalars(self, i: int, before: dict):
        """The fourteen host scalars of tick ``i``, worked out again from the
        drive and the estimator's windows before the tick."""
        cfg = self.ref_cfg
        rotation, translation, v = self.ref_odometry(i)
        rot_prev, trans_prev = ((0.0, 0.0) if i == 0 else self.ref_odometry(i - 1)[:2])
        k = int(v != 0)
        icp = bool(cfg.use_icp_proposal)
        has_prev, has_prev2 = (i >= 1, i >= 2) if icp else (False, False)
        if cfg.adaptive_proposal_floors:
            est = ro.FloorEstimator(cfg, before["windows"])
            fxy, fth, a_xy, a_th, dial, b_th, lat_gate = est.read(k)
        else:
            est = None
            fxy, fth, a_xy, a_th, dial, b_th, lat_gate = (
                cfg.proposal_xy_floor, cfg.proposal_theta_floor, 0.0, 0.0, 1.0, 0.0, 1.0)
        scalars = (rotation, translation, rot_prev, trans_prev, float(v != 0), float(has_prev),
                   float(has_prev2), fxy, fth, a_xy, a_th, b_th, lat_gate, dial)
        return scalars, est, k, has_prev, has_prev2

    def reference_tick(self, i: int, snap: dict, dtype=torch.float32):
        """The reference's ``out`` row, returned pose, state and estimator
        windows after tick ``i``, computing the filter and the ICP in
        ``dtype``."""
        before, cfg = snap["before"], self.ref_cfg
        scalars, est, k, has_prev, has_prev2 = self.scalars(i, before)
        cast = lambda v: v if v.dtype in (torch.int32, torch.bool) else v.to(dtype)
        state = {n: cast(v) for n, v in before["state"].items()}
        draws = {n: cast(v) for n, v in snap["draws"].items() if v is not None}
        dev = self.device
        pts = torch.from_numpy(self.drive.points[i]).to(dev)
        vld = torch.from_numpy(self.drive.valid[i]).to(dev)
        out, after = ro.tick(state, before["prev"], before["prev2"], pts, vld, scalars, draws,
                             cfg, self.fs2, icp_dtype=dtype)
        out = out.float().cpu().numpy()
        windows = None
        if est is not None:
            rotation, translation, _ = self.ref_odometry(i)
            ro.push_tick(est, k, out, rotation, translation, has_prev, has_prev2,
                         before["prev_se2"])
            windows = est.w
        if before["iteration"] < cfg.warmup_iterations:
            robot = before["robot"].copy()
            robot[2] = (robot[2] + float(out[3]) + np.pi) % (2 * np.pi) - np.pi
            robot[0] += float(out[4]) * np.cos(robot[2])
            robot[1] += float(out[4]) * np.sin(robot[2])
        else:
            robot = out[:3].astype(float)
        return out, robot, {n: v if v.dtype == torch.int32 else v.float()
                            for n, v in after.items()}, windows

    @staticmethod
    def program_result(snap) -> tuple:
        """The program's ``out`` row, returned pose, state and estimator
        windows after a sampled tick."""
        after = snap["after"]
        return snap["out"], snap["pose"], after["state"], after.get("windows")

    def compare(self, got, want) -> tuple:
        """(widest gap of the ``out`` row and returned pose, the yaw's taken
        around the circle; widest gap of an estimator window entry; share of
        particles apart) between two results of a tick."""
        tol = float(self.cell.limits["apart_tolerance"])
        gap = lambda a, b: float(np.nan_to_num(np.max(np.abs(np.asarray(a, np.float64)
                                                             - np.asarray(b, np.float64))),
                                               nan=np.inf))
        out_gap = 0.0
        for a, b in ((got[0], want[0]), (got[1], want[1])):   # out[14]; the returned pose
            d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
            d[2] = min(d[2], 2 * np.pi - d[2])                 # yaw, around the circle
            out_gap = max(out_gap, float(np.nan_to_num(np.max(d), nan=np.inf)))
        est_gap = 0.0
        if want[3] is not None:
            for n in ESTIMATOR_WINDOWS:
                for key in (0, 1):
                    a, b = got[3][n][key], want[3][n][key]
                    est_gap = max(est_gap, gap(a, b) if len(a) == len(b) and a else
                                  (0.0 if len(a) == len(b) else np.inf))
        prog, state = got[2], want[2]
        p = prog["poses"].shape[0]
        apart = torch.zeros(p, dtype=torch.bool, device=prog["poses"].device)
        for k in rf.FIELDS:
            a, b = prog[k], state[k]
            if k == "lm_count":
                apart |= a != b
                continue
            close = (a.float() - b.float()).abs() <= tol
            apart |= ~(close.all(dim=1) if k == "poses" else
                       close if a.dim() == 1 else close.all(dim=0))
        return out_gap, est_gap, float(apart.float().mean())

    def check(self, done_until: int) -> list:
        """The checks of the sampled ticks the window reached; the
        estimator's only where the configuration adapts its floors."""
        limits = self.cell.limits
        reached = [i for i in self.samples if i < done_until]
        out_gap = est_gap = apart = 0.0
        for i in reached:
            snap = self.snaps[i]
            g, e, a = self.compare(self.program_result(snap), self.reference_tick(i, snap))
            out_gap, est_gap, apart = max(out_gap, g), max(est_gap, e), max(apart, a)
        checks = [harness.Check("ticks_checked_short", float(not reached), 0.0),
                  harness.Check("out_gap", out_gap, float(limits["out_gap"]))]
        if self.ref_cfg.adaptive_proposal_floors:
            checks.append(harness.Check("estimator_gap", est_gap, float(limits["estimator_gap"])))
        return checks + [harness.Check("particles_apart", apart, float(limits["particles_apart"]))]


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device, *,
        overrides=None) -> harness.Outcome:
    orun = OnlineRun(cell, seed, device, overrides=overrides)
    seconds = harness.window_seconds(cell, seconds, trace)
    orun.setup(seconds)
    setup_s = harness.process_age_s()
    w = orun.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated(orun.device) if orun.cuda else 0
    orun.free()
    checks = orun.check(orun.t)
    lat = w["latencies"]
    p95_s = percentile(lat, 95) if lat else float("inf")
    outcome = harness.Outcome(
        attempted=len(lat) + w["failed"], failed=w["failed"],
        end_to_end={"frames_per_s": len(lat) / w["seconds"], "tick_p95_ms": 1e3 * p95_s,
                    "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak,
        ctx={"kind": "online", "ticks": len(lat), "mean_tick_s": float(np.mean(lat)),
             "p95_tick_s": p95_s})
    if trace:
        s = w["trace"]
        outcome.busy_s, outcome.window_s, outcome.breakdown = (
            s["busy_s"], s["window_s"], s["breakdown"])
        outcome.ctx.update(busy_s=s["busy_s"], window_s=s["window_s"])
    return outcome
