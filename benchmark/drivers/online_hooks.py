"""Online traffic with the production hooks on: the online driver's closed
loop (:mod:`benchmark.drivers.online`), and after every tick the program's
``ProductionHooks.after_tick``, exactly as ``app/runner.py:run_driver``
calls it: the health check, a ``tick`` record in the JSONL metrics log, a
viewer snapshot every ``serialize_every`` ticks and a checkpoint every
``checkpoint_every`` ticks, into a fresh temporary directory that is
removed when the run ends.  The configuration's ``hooks`` give the hooks.

The warm-up ticks run the hooks too (tick 0's snapshot among them).  The
window opens after them and closes when the first checkpoint that ends
after ``--seconds`` returns, so it holds whole checkpoint periods.  A
tick's latency is the tick's alone; ``frames_per_s`` counts the hooks' time
in the window.

After each tick's hooks the driver reads the snapshot's and the
checkpoint's file status (``os.stat``; each write replaces the file, so a
new inode or modification time is a new write), not the program's counters:
a file written at tick ``i`` is ``i - t`` ticks old at tick ``t``, and one
not yet written counts from tick 0, the run's start.

The check adds to the online driver's (the sampled ticks against the
plain reference, at that cell's limits) the hooks' files, against
:mod:`benchmark.reference.hooks`: the window's first and last checkpoint
and its first and latest snapshot, each kept as a hard link when its hook
returns (no copy, and it survives the next ``os.replace``) beside a copy of
the state of its tick; the metrics log's ``tick`` records of every window
tick; the health checks made; and the oldest the snapshot and the
checkpoint on disk were after any tick's hooks.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark import harness
from benchmark import trace as tracing
from benchmark.drivers import online
from benchmark.reference import filter as rf
from benchmark.reference import hooks as rh
from fastslam_tpu_torch.app.runner import ProductionHooks
from fastslam_tpu_torch.eval.metrics import evaluate_tick
from fastslam_tpu_torch.utils import profiling

MAP_FIELDS = ("poses", "lm_mx", "lm_my", "lm_count")


class HooksRun(online.OnlineRun):
    """One run of an online cell with the production hooks on."""

    def __init__(self, cell: harness.Cell, seed: int, device, *, overrides=None):
        super().__init__(cell, seed, device, overrides=overrides)
        h = cell.config["hooks"]
        self.dir = tempfile.mkdtemp(prefix="fastslam-hooks-")
        self.paths = {k: os.path.join(self.dir, name) for k, name in (
            ("metrics", "metrics.jsonl"), ("snapshot", "fast_slam.json"),
            ("checkpoint", "checkpoint.npz"))}
        self.hooks = ProductionHooks(
            self.cfg, health=bool(h["health"]),
            metrics_path=self.paths["metrics"] if h["metrics"] else None,
            serialize_path=self.paths["snapshot"], serialize_every=int(h["serialize_every"]),
            checkpoint_path=self.paths["checkpoint"],
            checkpoint_every=int(h["checkpoint_every"]))
        self.phase = tracing.phases(False)
        self.first = None                      # the window's first tick
        self.kept = {"checkpoint": {}, "snapshot": {}}
        # each file's status when last seen, the tick that wrote it, its
        # greatest age after a tick's hooks
        self.seen = {"checkpoint": None, "snapshot": None}
        self.written = {"checkpoint": 0, "snapshot": 0}
        self.oldest = {"checkpoint": 0, "snapshot": 0}
        self.est, self.gt = {}, {}             # by tick, as the hooks were given them

    def ground_truth(self, i: int) -> np.ndarray:
        """Tick ``i``'s pose in the filter's frame (the start pose's), as
        run_driver maps it."""
        x0, y0, yaw0 = self.cell.traffic["start_pose"]
        c0, s0 = np.cos(-yaw0), np.sin(-yaw0)
        x, y, yaw = self.drive.gt[i]
        dx, dy = x - x0, y - y0
        return np.array([c0 * dx - s0 * dy, s0 * dx + c0 * dy,
                         (yaw - yaw0 + np.pi) % (2 * np.pi) - np.pi])

    def setup(self, seconds: float) -> None:
        super().setup(seconds)
        # the kept files' copies, made here so the window allocates nothing
        state = self.runner.state
        fields = [k for k in (*rf.FIELDS, "lm_cc") if getattr(state, k, None) is not None]
        for kind, names in (("checkpoint", fields), ("snapshot", MAP_FIELDS)):
            for slot in ("first", "last"):
                self.kept[kind][slot] = {"state": {k: getattr(state, k).clone() for k in names},
                                         "tick": None}
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # --------------------------------------------------------------- a tick
    def tick(self):
        """The online tick, then the hooks; the latency is the tick's."""
        i = self.t
        dt, pose = super().tick()
        gt = self.gt[i] = self.ground_truth(i)
        self.est[i] = pose
        ev = evaluate_tick(gt, pose)
        with self.phase("bench.hooks"):
            self.hooks.after_tick(self.runner, i, pose, gt, ev)
        with self.phase("bench.keep"):
            for kind in ("checkpoint", "snapshot"):
                if self.observe(kind, i) and self.first is not None:
                    self.keep(kind, i)
        return dt, pose

    def observe(self, kind: str, i: int) -> bool:
        """Whether the hook ``kind``'s file was written at tick ``i``; its
        age after the tick's hooks goes into ``oldest``."""
        try:
            st = os.stat(self.paths[kind])
            status = (st.st_ino, st.st_mtime_ns, st.st_size)
        except FileNotFoundError:
            status = None
        wrote = status is not None and status != self.seen[kind]
        self.seen[kind] = status
        if wrote:
            self.written[kind] = i
        self.oldest[kind] = max(self.oldest[kind], i - self.written[kind])
        return wrote

    def keep(self, kind: str, i: int) -> None:
        """Link the file the hook ``kind`` wrote at tick ``i`` and copy the
        state it was written from: into the slot ``first`` once, then
        ``last``."""
        slots = self.kept[kind]
        k = slots["first"] if slots["first"]["tick"] is None else slots["last"]
        path = os.path.join(self.dir, f"kept-{kind}-{'first' if k is slots['first'] else 'last'}")
        if os.path.exists(path):
            os.unlink(path)
        os.link(self.paths[kind], path)
        r = self.runner
        for name, dst in k["state"].items():
            dst.copy_(getattr(r.state, name))
        k.update(tick=i, path=path, robot=r.robot.copy(),
                 generator=r._generator.get_state().clone())

    def window(self, seconds: float, trace: bool) -> dict:
        self.phase = phase = tracing.phases(trace)
        latencies, failed = [], 0
        self.first, checks0 = self.t, self.hooks.health_checks
        with tracing.profiled(trace) as prof:
            with phase(tracing.WINDOW):
                start = time.perf_counter()
                while True:
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
                    if (self.written["checkpoint"] == self.t - 1 > 0
                            and time.perf_counter() - start >= seconds):
                        break
                if self.cuda:
                    torch.cuda.synchronize(self.device)
                end = time.perf_counter()
        self.phase = tracing.phases(False)
        self.health_checks = self.hooks.health_checks - checks0
        out = {"latencies": latencies, "seconds": end - start, "failed": failed}
        if trace:
            out["trace"] = tracing.summarize(tracing.events(prof))
        return out

    def close(self) -> None:
        """Close the hooks' files and remove their directory."""
        self.hooks.close()
        shutil.rmtree(self.dir, ignore_errors=True)

    # ---------------------------------------------------------------- check
    def hook_readings(self) -> dict:
        """The numbers the hooks' files are compared by (before
        :meth:`close`)."""
        cfg, last = self.ref_cfg, self.t - 1
        ck = [k for k in self.kept["checkpoint"].values() if k["tick"] is not None]
        sn = [k for k in self.kept["snapshot"].values() if k["tick"] is not None]
        ck_gap = max((rh.checkpoint_gap(k["path"], rh.host(k["state"]), k["tick"], k["robot"],
                                        k["generator"].numpy()) for k in ck), default=0.0)
        sn_gaps = [rh.snapshot_gaps(k["path"], rh.host(k["state"]), self.est[k["tick"]],
                                    self.gt[k["tick"]], cfg.viz_cluster_eps,
                                    cfg.viz_min_samples_frac) for k in sn]
        h = self.hooks
        return {
            "checkpoints_checked_short": float(not ck),
            "checkpoint_gap": ck_gap,
            "snapshots_checked_short": float(not sn),
            "snapshot_gap": max((g[0] for g in sn_gaps), default=0.0),
            "snapshot_pose_gap": max((g[1] for g in sn_gaps), default=0.0),
            "metrics_gap": rh.metrics_gap(self.paths["metrics"], self.first, last, self.est,
                                          self.gt) if h.metrics else 0.0,
            "health_checks_missed": float(last + 1 - self.first - self.health_checks)
            if h.monitor is not None else 0.0,
            "snapshot_lag_ticks": float(self.oldest["snapshot"]),
            "checkpoint_lag_ticks": float(self.oldest["checkpoint"]),
        }

    def check(self, done_until: int) -> list:
        limits = self.cell.limits
        return super().check(done_until) + [
            harness.Check(name, value, float(limits[name]))
            for name, value in self.hook_readings().items()]


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device, *,
        overrides=None) -> harness.Outcome:
    hrun = HooksRun(cell, seed, device, overrides=overrides)
    try:
        seconds = harness.window_seconds(cell, seconds, trace)
        hrun.setup(seconds)
        setup_s = harness.process_age_s()
        profiling.TICK_TRACE.clear()
        profiling.HOOK_TRACE.clear()
        w = hrun.window(seconds, trace)
        peak = torch.cuda.max_memory_allocated(hrun.device) if hrun.cuda else 0
        hrun.hooks.close()
        hrun.free()
        checks = hrun.check(hrun.t)
    finally:
        hrun.close()
    lat = w["latencies"]
    outcome = harness.Outcome(
        attempted=len(lat) + w["failed"], failed=w["failed"],
        end_to_end={"frames_per_s": len(lat) / w["seconds"], "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak,
        ctx={"kind": "online", "ticks": len(lat), "mean_tick_s": float(np.mean(lat)),
             "p95_tick_s": online.percentile(lat, 95) if lat else float("inf")})
    if trace:
        s = w["trace"]
        outcome.busy_s, outcome.window_s, outcome.breakdown = (
            s["busy_s"], s["window_s"], s["breakdown"])
        outcome.ctx.update(busy_s=s["busy_s"], window_s=s["window_s"])
        report_cover(outcome.ctx)
    return outcome


def report_cover(ctx: dict) -> None:
    """On stderr: the share of the traced window's wall time inside the
    tick's own span and the hooks' row spans, and each hook's seconds and
    calls in the window."""
    spans = lambda recorder: [s for r in recorder.rows() for s in r["spans"]]
    total = lambda rows, name: 1e-9 * sum(t1 - t0 for n, _, t0, t1 in rows if n == name)
    ticks, hooks = spans(profiling.TICK_TRACE), spans(profiling.HOOK_TRACE)
    inside = total(ticks, "tick") + total(hooks, "hook")
    print(f"spans cover {100.0 * inside / ctx['window_s']:.2f} % of the "
          f"{ctx['window_s']:.3f} s window: tick {total(ticks, 'tick'):.3f} s, hooks "
          + ", ".join(f"{name} {total(hooks, name):.3f} s / {sum(n == name for n, *_ in hooks)}"
                      for name in ("hook", "health", "metrics", "serialize", "checkpoint")),
          file=sys.stderr, flush=True)
