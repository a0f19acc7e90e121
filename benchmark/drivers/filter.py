"""Chunked filter traffic: the program's chunked step, one chunk per replay
of a CUDA graph, replayed back to back with new draws made on the card
before each replay.

Set-up builds the program's state and inputs, runs one chunk eagerly
(which builds the kernels, or finds them built in the checkout), captures
one chunk into a CUDA graph that reads and writes static tensors, and
replays it ``warmup_replays`` times.  The window then replays the graph
until ``--seconds`` have passed, never more than ``lookahead_replays``
replays ahead of the card, and synchronizes once at its end.

The check follows the program's own state.  Before the chunks that the
seed draws (one in each bucket of ``check_buckets``, where the window
reaches it) the harness copies the state and the draws aside, and after
them the state and the estimate rows; once the window has closed and the
program is freed, the plain reference (``reference/filter.py``) runs each
sampled chunk from the copied state with the copied draws, and its
estimate rows and state are compared with the program's.  A graph of one
chunk exposes every chunk boundary, so the check starts from the program's
state there and the resample's staircase, which turns any rounding into
other ancestors, cannot compound across chunks.
"""

from __future__ import annotations

import math
import time
from collections import deque

import numpy as np
import torch

from benchmark import harness, roofline
from benchmark import trace as tracing
from benchmark.reference import filter as ref

FIELDS = ref.FIELDS


def program_config(cell: harness.Cell, overrides: dict | None = None):
    from fastslam_tpu_torch.config import FastSLAMConfig

    return FastSLAMConfig(**{**cell.config["program"], **(overrides or {})})


def program_step():
    from fastslam_tpu_torch.core import kernels

    return kernels.fastslam_steps_planes_chunked


def measurement_rows(traffic: dict) -> np.ndarray:
    """The mix's (range, bearing) rows of every tick."""
    m = traffic["measurements"]
    i = np.arange(m["count"], dtype=np.float64)
    return np.stack([m["range_start"] + m["range_step"] * i,
                     m["bearing_start"] + m["bearing_step"] * i], -1).astype(np.float32)


def sample_chunks(seed: int, buckets: list) -> list:
    """One chunk index drawn from the seed in each bucket ``[a, b)``."""
    rng = np.random.default_rng(seed)
    return [int(rng.integers(a, b)) for a, b in zip(buckets[:-1], buckets[1:])]


def state_dict(state) -> dict:
    return {k: getattr(state, k) for k in FIELDS}


def clone(d: dict) -> dict:
    return {k: v.clone() for k, v in d.items()}


def copy_into(dst: dict, src: dict) -> None:
    for k, v in dst.items():
        v.copy_(src[k])


class FilterRun:
    """One run of a chunked filter cell on ``device``; ``overrides``
    change the program's configuration (tests run tiny sizes on the CPU)."""

    def __init__(self, cell: harness.Cell, seed: int, device, *, overrides=None):
        from fastslam_tpu_torch.core import kernels
        from fastslam_tpu_torch.core.state import Measurements, init_planes_state

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cuda = self.device.type == "cuda"
        t = cell.traffic
        self.cfg = program_config(cell, overrides)
        self.fs2 = kernels.uses_fs2(self.cfg)
        self.step_fn = program_step()
        self.p, self.c = self.cfg.num_particles, int(cell.config["chunk_ticks"])
        rows = measurement_rows(t)
        self.measured = len(rows)
        m = self.cfg.max_measurements
        z = np.zeros((self.c, m, 2), np.float32)
        z[:, :self.measured] = rows
        valid = np.zeros((self.c, m), bool)
        valid[:, :self.measured] = True
        dev = self.device
        self.z = torch.from_numpy(z).to(dev)
        self.z_valid = torch.from_numpy(valid).to(dev)
        self.ms = Measurements(self.z, self.z_valid)
        self.rots = torch.full((self.c,), float(t["rotation"]), dtype=torch.float32, device=dev)
        self.trans = torch.full((self.c,), float(t["translation"]), dtype=torch.float32,
                                device=dev)
        self.state = init_planes_state(self.cfg, dev)
        self.start = clone(state_dict(self.state))
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        z32 = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
        self.draws = ({"noise": z32(self.c, 3, self.p), "u0": z32()} if self.fs2 else
                      {"rot": z32(self.c, self.p), "trans": z32(self.c, self.p), "u0": z32()})
        self.est = z32(self.c, 3)
        self.graph = None
        self.samples = sample_chunks(seed, t["check_buckets"])
        self.snaps = {}

    # -------------------------------------------------------------- program
    def fill(self) -> None:
        """New draws into the static draw tensors: standard normals, and
        ``u0`` uniform in ``[0, 1/P)``."""
        for k, v in self.draws.items():
            if k == "u0":
                v.uniform_(0.0, 1.0 / self.p, generator=self.gen)
            else:
                v.normal_(generator=self.gen)

    def body(self) -> None:
        """One chunk through the program, deciding its resample on the
        device, the state and estimates written back in place."""
        from fastslam_tpu_torch.core.kernels import Draws

        d = self.draws
        draws = (Draws(None, None, d["u0"], d["noise"]) if self.fs2 else
                 Draws(d["rot"], d["trans"], d["u0"], None))
        new, est = self.step_fn(self.state, self.rots, self.trans, self.ms, self.cfg, draws,
                                on_device=True)
        for k in FIELDS:
            getattr(self.state, k).copy_(getattr(new, k))
        self.est.copy_(est)

    def setup(self) -> None:
        harness.log_setup("state and inputs")
        self.fill()
        self.body()                       # builds the kernels (or loads them)
        if self.cuda:
            torch.cuda.synchronize(self.device)
            harness.log_setup("first chunk")
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.body()
            harness.log_setup("capture")
        for _ in range(int(self.cell.traffic["warmup_replays"])):
            self.fill()
            self.launch()
        for i in self.samples:
            self.snaps[i] = {"in": clone(state_dict(self.state)), "draws": clone(self.draws),
                             "out": clone(state_dict(self.state)), "est": self.est.clone()}
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def launch(self) -> None:
        """One replay of the graph (on the CPU, the body eagerly)."""
        if self.graph is not None:
            self.graph.replay()
        else:
            self.body()

    def window(self, seconds: float, trace: bool) -> dict:
        """Replays until ``seconds`` have passed; returns the chunks done,
        the window's seconds and, traced, the trace's summary."""
        phase = tracing.phases(trace)
        lookahead = int(self.cell.traffic["lookahead_replays"])
        pending, done = deque(), 0
        snaps = self.snaps
        with tracing.profiled(trace) as prof:
            with phase(tracing.WINDOW):
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    snap = snaps.get(done)
                    with phase("bench.fill"):
                        self.fill()
                    if snap is not None:
                        with phase("bench.snapshot"):
                            copy_into(snap["in"], state_dict(self.state))
                            copy_into(snap["draws"], self.draws)
                    with phase("bench.replay"):
                        self.launch()
                    if snap is not None:
                        with phase("bench.snapshot"):
                            copy_into(snap["out"], state_dict(self.state))
                            snap["est"].copy_(self.est)
                    done += 1
                    if self.cuda:
                        ev = torch.cuda.Event()
                        ev.record()
                        pending.append(ev)
                        if len(pending) > lookahead:
                            with phase("bench.wait"):
                                pending.popleft().synchronize()
                with phase("bench.drain"):
                    if self.cuda:
                        torch.cuda.synchronize(self.device)
                t1 = time.perf_counter()
        out = {"chunks": done, "seconds": t1 - t0}
        if trace:
            out["trace"] = tracing.summarize(tracing.events(prof))
        return out

    def free(self) -> None:
        """Drop the graph and the program's state (the copies stay)."""
        self.graph = None
        self.state = None
        if self.cuda:
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- check
    def ref_config(self) -> dict:
        return {k: getattr(self.cfg, k) for k in (
            "measurement_noise", "default_landmark_cov", "max_landmark_distance",
            "rotation_noise", "translation_noise", "proposal_xy_floor",
            "proposal_theta_floor", "fs2_evidence_weights", "resample_threshold_frac")}

    def reference_chunk(self, state: dict, draws: dict, dtype=torch.float32):
        """The reference over one chunk from ``state`` with ``draws``,
        computing in ``dtype``.  Returns the estimate rows ``[C, 3]``, the
        state after, and the chunk's least seconds."""
        cfg = self.ref_config()
        state = {k: (v if k == "lm_count" else v.to(dtype)) for k, v in state.items()}
        traj, after = ref.chunk_update(state, self.rots, self.trans, self.z, self.z_valid,
                                       draws, cfg, self.fs2)
        written = int(torch.stack([after[k] != state[k] for k in ref.PLANES]).any(0).sum())
        new, resampled = ref.boundary(after, draws["u0"].to(dtype), cfg)
        bound = roofline.chunk_bound_s(
            p=self.p, c=self.c, measured=self.measured, occupied=int(state["lm_count"].sum()),
            written=written, resampled=resampled, fs2=self.fs2)
        return (ref.estimates(traj).float(),
                {k: v if k == "lm_count" else v.float() for k, v in new.items()}, bound)

    def compare(self, est, state, ref_est, ref_state) -> tuple:
        """(widest gap of an estimate row, the yaw's taken around the
        circle; share of particles whose state lies apart from the
        reference's by more than the limit's tolerance)."""
        tol = float(self.cell.limits["apart_tolerance"])
        d = (est - ref_est).abs()
        d[..., 2] = torch.minimum(d[..., 2], 2 * math.pi - d[..., 2])    # yaw, around the circle
        est_gap = float(torch.nan_to_num(d, nan=float("inf")).max())
        apart = torch.zeros(self.p, dtype=torch.bool, device=est.device)
        for k in FIELDS:
            a, b = state[k], ref_state[k]
            if k == "lm_count":
                apart |= a != b
                continue
            close = (a.float() - b.float()).abs() <= tol
            apart |= ~(close.all(dim=1) if k == "poses" else
                       close if a.dim() == 1 else close.all(dim=0))
        return est_gap, float(apart.float().mean())

    def check(self, done: int) -> tuple:
        """The checks of the chunks the window reached, and the least
        seconds per tick the reference counted."""
        limits = self.cell.limits
        start_ref = ref.init_state(self.p, self.cfg.max_landmarks, self.device)
        start_gap = max(float((self.start[k].float() - start_ref[k].float()).abs().max())
                        for k in FIELDS)
        reached = [i for i in self.samples if i < done]
        est_gap, apart, bounds = 0.0, 0.0, []
        for i in reached:
            snap = self.snaps[i]
            ref_est, ref_state, bound = self.reference_chunk(snap["in"], snap["draws"])
            g, a = self.compare(snap["est"], snap["out"], ref_est, ref_state)
            est_gap, apart = max(est_gap, g), max(apart, a)
            bounds.append(bound)
        checks = [harness.Check("start_gap", start_gap, float(limits["start_gap"])),
                  harness.Check("chunks_checked_short", float(not reached), 0.0),
                  harness.Check("est_gap", est_gap, float(limits["est_gap"])),
                  harness.Check("particles_apart", apart, float(limits["particles_apart"]))]
        bound_per_tick = sum(bounds) / (len(bounds) * self.c) if bounds else None
        return checks, bound_per_tick


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device, *,
        overrides=None) -> harness.Outcome:
    """Set-up, the window, the check; ``setup_s`` runs from the process's
    start to the window's."""
    fr = FilterRun(cell, seed, device, overrides=overrides)
    fr.setup()
    setup_s = harness.process_age_s()
    w = fr.window(harness.window_seconds(cell, seconds, trace), trace)
    peak = torch.cuda.max_memory_allocated(fr.device) if fr.cuda else 0
    fr.free()
    checks, bound_per_tick = fr.check(w["chunks"])
    ticks = w["chunks"] * fr.c
    outcome = harness.Outcome(
        attempted=w["chunks"], failed=0,
        end_to_end={"updates_per_s": fr.p * fr.measured * ticks / w["seconds"],
                    "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak,
        ctx={"kind": "filter", "ticks": ticks, "bound_s_per_tick": bound_per_tick})
    if trace:
        s = w["trace"]
        outcome.busy_s, outcome.window_s, outcome.breakdown = (
            s["busy_s"], s["window_s"], s["breakdown"])
        outcome.ctx.update(busy_s=s["busy_s"], window_s=s["window_s"])
    return outcome
