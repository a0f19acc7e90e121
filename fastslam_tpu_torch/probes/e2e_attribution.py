"""Attribute the online tick: per-launch overhead, frontend and filter (the
counterpart of ``scripts/bench_e2e_attribution.py``).

The script's three measurements, each as K ticks in one captured CUDA graph
(the harness of :mod:`fastslam_tpu_torch.probes.step`; every step decides
its resample on the device, the draws are made eagerly into static tensors
inside the timed region, and each graph is held bit for bit to its eager
run), on the scans of ``SimWorld(seed=2)`` at P=100,000, L=64, M=16,
production, the motion proposal:

1. the K-sweep of the full tick, ``scan_to_measurements`` then
   ``fastslam_step_planes``, for K in {16, 64, 192}, and the linear fit
   ``total = a K + b``: ``per_tick_ms_asymptotic`` (a) and
   ``per_dispatch_overhead_ms`` (b, the constant cost of one replay);
2. the frontend alone at K = 192, a reduction of its measurements carried
   from tick to tick so that nothing is dead;
3. the filter alone at K = 192: the per-tick planes step with 16 fixed
   measurements (``bench.py``'s set, rotation 0, translation 0.4).

What the port adds, because its production tick is not one dispatch per K
ticks: the wall time per tick of ``SLAMRunner.tick_fused`` (one replay of
the fused tick's graph per tick, ``app/runner.py:_FusedTick``) over the same
192 scans, at the same config (motion proposal, no ICP, production,
``fuse_online_tick=True``), on the host clock: its median and 90th
percentile over the ticks after the first (which runs eagerly and captures
the graph), beside the device ms of one replay of that graph (CUDA events
around each of 20 replays after the run, their median).  The gap between
that tick's wall time and the sweep's per-tick asymptote is the host's
share: the tick's inputs and draws, the copies, the launch and the read
back.  ``host_ms_beyond_replay`` is the wall time less the replay's device
time.

Writes ``eval_results/torch/e2e_attribution.json`` (``--out``) and prints
one JSON line, with the card's name and power limit::

    python -m fastslam_tpu_torch.probes.e2e_attribution [--particles 100000] \\
        [--device cuda] [--out FILE]

On ``--device cpu`` every loop runs eagerly on the plain versions, once,
and the tick runs eagerly (no graph, no device times).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.probes import step as step_probe
from fastslam_tpu_torch.probes.step import Carry, Loop, make_scan_inputs

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(REPO, "eval_results", "torch", "e2e_attribution.json")
KS = (16, 64, 192)
PARTICLES = 100_000
REPS = 6               # the script's _sync_best: 6 repetitions, the best
REPLAYS = 20           # replays of the fused tick's graph timed after its run
NOTE = ("filter_ms is at 16 fixed valid measurements; the e2e log averages ~2, "
        "so components are not additive")


def config(particles: int = PARTICLES) -> FastSLAMConfig:
    """The script's config (``:103-106``): production, motion proposal."""
    return FastSLAMConfig(num_particles=particles, max_landmarks=64, max_measurements=16,
                          parity_mode=False)


def step_args(particles: int, k: int, frontend: bool):
    """The :mod:`~fastslam_tpu_torch.probes.step` path of a sweep or
    filter loop: ``planes+frontend+prod`` or ``planes+prod``."""
    argv = ["--planes", "--production", "--k", str(k), "--particles", str(particles)]
    return step_probe.parse(argv + (["--with-frontend"] if frontend else []))


def frontend_loop(k: int, cfg: FastSLAMConfig, device) -> Loop:
    """The frontend alone over K scans: a float carried from tick to tick
    gains the sum of each tick's measurements and of their valid flags
    (``:142-156``); the last tick's first valid flag is read back."""
    from fastslam_tpu_torch.frontend.pipeline import scan_to_measurements

    pts, vld, _, _ = make_scan_inputs(k, cfg, device)

    def step(s, i, d, on_device):
        ms = scan_to_measurements(pts[i], vld[i], cfg)
        value = s.value + torch.sum(ms.range_bearing) + torch.sum(ms.valid)
        return s.replace(value=value), ms.valid[0]
    carry = Carry(torch.zeros((), dtype=torch.float32, device=device))
    return Loop(carry, step, k, cfg.num_particles)


def sweep(particles: int, device, ks=KS, reps: int = REPS) -> dict:
    """Measurement 1: ms per tick of the full tick for each K, and the
    linear fit."""
    by_k, capture_s = {}, {}
    for k in ks:
        loop = step_probe.build_loop(step_args(particles, k, True), device)
        res = step_probe.time_loop(loop, device, reps=reps, eager=False)
        total = res["graph_ms"] if res["graph_ms"] is not None else res["eager_ms"]
        by_k[k], capture_s[k] = total / k, res["build_and_capture_s"]
        print(f"e2e K={k}: {total / k:.3f} ms/tick", file=sys.stderr)
    out = {"e2e_ms_per_tick_by_k": {k: round(v, 4) for k, v in by_k.items()},
           "build_and_capture_s_by_k": {k: round(v, 2) for k, v in capture_s.items()}}
    if len(ks) >= 2:
        ks_arr = np.array(sorted(by_k), dtype=np.float64)
        a, b = np.polyfit(ks_arr, np.array([by_k[k] * k for k in sorted(by_k)]), 1)
        out |= {"per_tick_ms_asymptotic": round(float(a), 4),
                "per_dispatch_overhead_ms": round(float(b), 4)}
    return out


def frontend_only(particles: int, device, k: int = KS[-1], reps: int = REPS) -> float:
    """Measurement 2: ms per tick of the frontend alone."""
    res = step_probe.time_loop(frontend_loop(k, config(particles), device), device,
                               reps=reps, eager=False)
    ms = (res["graph_ms"] if res["graph_ms"] is not None else res["eager_ms"]) / k
    print(f"frontend: {ms:.3f} ms/tick", file=sys.stderr)
    return ms


def filter_only(particles: int, device, k: int = KS[-1], reps: int = REPS) -> float:
    """Measurement 3: ms per tick of the per-tick planes step, 16 fixed
    measurements."""
    loop = step_probe.build_loop(step_args(particles, k, False), device)
    res = step_probe.time_loop(loop, device, reps=reps, eager=False)
    ms = (res["graph_ms"] if res["graph_ms"] is not None else res["eager_ms"]) / k
    print(f"filter: {ms:.3f} ms/tick", file=sys.stderr)
    return ms


def fused_tick(particles: int, device, k: int = KS[-1], replays: int = REPLAYS) -> dict:
    """``SLAMRunner.tick_fused`` over the K scans: host-clock ms per tick
    (the first tick, eager and the capture, apart), and the device ms of
    one replay of its graph."""
    from fastslam_tpu_torch.app.runner import SLAMRunner

    cfg = config(particles)
    pts, vld, rots, trs = (t.cpu().numpy() for t in make_scan_inputs(k, cfg, "cpu"))
    runner = SLAMRunner(cfg, rng=0, device=device)
    walls = []
    for i in range(k):
        t0 = time.perf_counter()
        runner.tick_fused(pts[i], vld[i], float(rots[i]), float(trs[i]), float(trs[i] != 0))
        walls.append((time.perf_counter() - t0) * 1e3)
    later = walls[1:]
    out = {"ticks": k, "first_tick_ms": round(walls[0], 3),
           "wall_ms_median": round(statistics.median(later), 4),
           "wall_ms_p90": round(float(np.percentile(later, 90)), 4),
           "graph_replays": runner._fused.replays, "device_ms_per_replay": None}
    graph = runner._fused.graph
    if graph is not None:
        times = []
        for _ in range(replays):
            start, stop = step_probe.events()
            start.record()
            graph.replay()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        out["device_ms_per_replay"] = round(statistics.median(times), 4)
        out["host_ms_beyond_replay"] = round(out["wall_ms_median"]
                                             - out["device_ms_per_replay"], 4)
    return out


def run(device="cuda", particles: int = PARTICLES, ks=KS, out_path: str | None = OUT,
        reps: int | None = None) -> dict:
    """Every measurement; returns the record (written to ``out_path``
    unless None)."""
    from fastslam_tpu_torch.eval.oracle_ate import check_device
    from fastslam_tpu_torch.probes import device_fields

    device = check_device(device)
    reps = reps or (REPS if device.type == "cuda" else 1)
    out = {"config": {"particles": particles, "P": "planes per-tick", "landmarks": 64,
                      "measurements": 16, "production": True},
           "graph": device.type == "cuda"}
    out |= sweep(particles, device, ks, reps)
    out["frontend_ms_per_tick"] = round(frontend_only(particles, device, ks[-1], reps), 4)
    out["filter_ms_per_tick"] = round(filter_only(particles, device, ks[-1], reps), 4)
    out["note"] = NOTE
    tick = fused_tick(particles, device, ks[-1])
    if "per_tick_ms_asymptotic" in out:
        tick["gap_to_asymptote_ms"] = round(tick["wall_ms_median"]
                                            - out["per_tick_ms_asymptotic"], 4)
    out["fused_tick"] = tick
    out |= device_fields(device)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fastslam_tpu_torch.probes.e2e_attribution")
    ap.add_argument("--particles", type=int, default=PARTICLES)
    ap.add_argument("--ks", type=int, nargs="+", default=list(KS),
                    help="the sweep's K values (the last also sizes the frontend, "
                         "filter and fused-tick runs)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--out", default=OUT, help="the JSON file to write")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.particles, tuple(args.ks), args.out)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
