"""Weak scaling of the sharded filter step on shards of one card (the
counterpart of ``scripts/bench_scaling.py``).

The script runs the sharded step with a fixed number of particles per
device at 1, 2, 4, ... devices and reports steps/s and the efficiency
against one device; under ``--virtual N`` it runs N virtual CPU devices,
which checks the sharding and collective structure, not interconnect
bandwidth.  Here the shards are S shards of one card (``--device cuda``) or
of the CPU: **shards of one card: the structure and the per-shard host cost,
not an interconnect**.  The north star's >= 80 % across chips cannot be read
from it; PERF §2's bar of at most 1.3x the single-shard time at S = 4 can.

For S = 1, 2, 4, ... up to ``--shards``, at ``--per-device`` particles per
shard (the script's config: L=64, M=16, ``bench.py``'s measurements,
rotation 0, translation 0.4), 3 warm steps, then ``--steps`` steps timed
with CUDA events (the host clock on the CPU), the draws made eagerly inside
the loop:

* ``make_sharded_step``, the blocks step (the script's), in its config's
  parity mode; one row per S with the script's keys (``devices``,
  ``particles``, ``step_ms``, ``frames_per_s``, ``weak_scaling_efficiency``,
  ``updates_per_s``), then the script's ``{"scaling": [...]}``;
* ``make_sharded_planes_chunked_step``, the chunked step (production, C =
  ``--chunk`` ticks per call), the form that meets PERF §2's bar: the same
  keys per tick, under ``scaling_chunked``.

Before timing, each S's first tick (chunk) is held bit for bit to the same
tick on one shard of the same particles (``equal_to_one_shard``); the probe
raises if it differs.  Every row carries the card's name and power limit::

    python -m fastslam_tpu_torch.probes.scaling [--per-device 12500] [--steps 20] \\
        [--shards 8] [--chunk 16] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import (
    Measurements, init_planes_state, init_state, pad_measurements,
)
from fastslam_tpu_torch.parallel.mesh import (
    make_mesh, shard_planes_state, shard_state, unshard,
)
from fastslam_tpu_torch.parallel.sharded import (
    make_sharded_planes_chunked_step, make_sharded_step,
)
from fastslam_tpu_torch.probes.step import bench_measurements, events

LABEL = "shards of one card: the structure and the per-shard host cost, not an interconnect"
WARM = 3


def shard_counts(n: int):
    """1, 2, 4, ... up to ``n``, as the script doubles its device count."""
    out, s = [], 1
    while s <= n:
        out.append(s)
        s *= 2
    return out


class Stepper:
    """One sharded step at S shards: ``state`` its sharded state, ``run()``
    one step with new draws, ``ticks`` per step."""

    def __init__(self, kind: str, cfg: FastSLAMConfig, shards: int, device, chunk: int,
                 seed: int = 0):
        self.mesh = make_mesh(cfg, [device] * shards)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        ms = pad_measurements(cfg, bench_measurements(cfg.max_measurements), device)
        p = cfg.num_particles
        if kind == "blocks":
            self.ticks = 1
            step = make_sharded_step(cfg, self.mesh)
            self.state = shard_state(init_state(cfg, device), self.mesh, cfg)
            self._run = lambda s: step(s, 0.0, 0.4, ms, kernels.draw(self.gen, p))
        else:
            self.ticks = chunk
            step = make_sharded_planes_chunked_step(cfg, self.mesh, chunk)
            self.state = shard_planes_state(init_planes_state(cfg, device), self.mesh, cfg)
            rots = torch.zeros(chunk, device=device)
            trans = torch.full((chunk,), 0.4, device=device)
            ms_c = Measurements(ms.range_bearing[None].expand(chunk, -1, -1).contiguous(),
                                ms.valid[None].expand(chunk, -1).contiguous())
            self._run = lambda s: step(s, rots, trans, ms_c,
                                       kernels.draw(self.gen, p, chunk))

    def run(self):
        self.state, est = self._run(self.state)
        return est


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def same_as_one_shard(kind: str, cfg: FastSLAMConfig, shards: int, device, chunk: int) -> bool:
    """One step at ``shards`` shards against one shard of the same
    particles, from the same state and draws: every field and the estimate
    bit for bit."""
    a, b = (Stepper(kind, cfg, s, device, chunk) for s in (shards, 1))
    ea, eb = a.run(), b.run()
    ua, ub = unshard(a.state, a.mesh), unshard(b.state, b.mesh)
    same = lambda x, y: (x is None and y is None) or (x is not None and y is not None
                                                      and torch.equal(x, y))
    return torch.equal(ea, eb) and all(same(getattr(ua, k), getattr(ub, k))
                                       for k in vars(ua))


def time_steps(stepper: Stepper, steps: int, device) -> float:
    """Seconds per step: ``WARM`` steps, then ``steps`` timed."""
    for _ in range(WARM):
        stepper.run()
    _sync(device)
    if device.type == "cuda":
        start, stop = events()
        start.record()
        for _ in range(steps):
            stepper.run()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3 / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        stepper.run()
    return (time.perf_counter() - t0) / steps


def scaling(kind: str, per_device: int, landmarks: int, measurements: int, steps: int,
            shards: int, chunk: int, device, fields: dict, print_rows: bool = True) -> list:
    """The rows of one step kind."""
    rows, base_rate = [], None
    for s in shard_counts(shards):
        cfg = FastSLAMConfig(num_particles=per_device * s, max_landmarks=landmarks,
                             max_measurements=measurements,
                             parity_mode=kind == "blocks")   # blocks: the script's default
        if not same_as_one_shard(kind, cfg, s, device, chunk):
            raise AssertionError(f"{kind} step at S={s}: differs from one shard")
        stepper = Stepper(kind, cfg, s, device, chunk)
        dt = time_steps(stepper, steps, device) / stepper.ticks      # per tick
        rate = 1.0 / dt
        base_rate = base_rate or rate
        rows.append({
            "devices": s,
            "particles": cfg.num_particles,
            "step_ms": round(dt * 1e3, 4),
            "frames_per_s": round(rate, 2),
            "weak_scaling_efficiency": round(rate / base_rate, 3),
            "updates_per_s": round(cfg.num_particles * measurements * rate),
            "step": "blocks" if kind == "blocks" else f"chunked{chunk}",
            "equal_to_one_shard": True,
            **fields,
        })
        if print_rows:
            print(json.dumps(rows[-1]), flush=True)
        del stepper
    return rows


def run(device="cuda", per_device: int = 12_500, landmarks: int = 64, measurements: int = 16,
        steps: int = 20, shards: int = 8, chunk: int = 16, print_rows: bool = True) -> dict:
    """Both step kinds' rows; returns the summary record."""
    from fastslam_tpu_torch.eval.oracle_ate import check_device
    from fastslam_tpu_torch.probes import device_fields

    device = check_device(device)
    fields = device_fields(device) | {"label": LABEL}
    args = (per_device, landmarks, measurements, steps, shards, chunk, device, fields,
            print_rows)
    blocks = scaling("blocks", *args)
    chunked = scaling("chunked", *args)
    return {"scaling": blocks, "scaling_chunked": chunked, **fields}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fastslam_tpu_torch.probes.scaling")
    ap.add_argument("--per-device", type=int, default=12_500, help="particles per shard")
    ap.add_argument("--landmarks", type=int, default=64)
    ap.add_argument("--measurements", type=int, default=16)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--shards", type=int, default=8, help="the largest shard count")
    ap.add_argument("--chunk", type=int, default=16, help="ticks per chunked step")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.per_device, args.landmarks, args.measurements,
                         args.steps, args.shards, args.chunk)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
