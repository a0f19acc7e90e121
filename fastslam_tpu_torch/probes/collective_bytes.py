"""Collective ops and bytes per step of the sharded filter step, for each
resampler (the counterpart of ``scripts/collective_bytes.py``).

The script compiles the sharded blocks step on 8 devices and sums the
result bytes of every collective in the compiled HLO.  The port has no HLO:
it runs the step on a mesh of ``--devices`` shards of one card (or of the
CPU) under ``parallel/collectives.py:tally``, which records every
collective the step issues with the bytes of its result as one shard holds
it, as the script reckons an HLO result type (``:51-66``).  A scalar op is
one of 256 bytes or less.

Three resamplers, each with the script's config (production, L=64, M=16,
the measurements ``(2.0, 0.3), (3.5, -0.7)``, rotation 0, translation 0.4)
at ``--per-device`` particles per shard:

* ``gspmd_resample``: ``make_sharded_step``'s single-device branch, the
  whole state gathered over the mesh, resampled, and split back;
* ``halo_resample``: ``distributed_resample=True``, the halo resampler in
  the step;
* ``ring_resample``: ``parallel/ring_resample.py:ring_halo_resample`` (the
  ring exchange kernel on the card), forced once on the state of the tick.

The script counts both branches of the Neff conditional, because the
compiled module holds both (its docstring).  The port runs them: each
resampler's ``branches`` are ``no_resample`` (a tick whose Neff test fails,
``resample_threshold_frac=0``) and ``resample`` (the resample's own ops
alone: those of a forced resample, ``resample_threshold_frac=2``, inside
its ``site``), and its top-level keys are their sum, the worst case per
tick.  ``by_site`` gives the bytes of each site (``whole_state``, ``halo``,
``ring``) and of the rest of the tick (``step``).

Ops the port and the script count differently: the port gathers the
``[P]`` weights to keep its float reductions bit for bit
(``parallel/collectives.py``), where XLA reduces within each device and
all-reduces scalars; the halo resampler moves the weights too, which XLA
drops in production (they are reset to uniform); the port's ``split`` (the
gathered state's re-split) has no op in XLA, which slices locally; and the
script's module also holds the halo resampler's fallback branch (a
whole-state gather) that a run with healthy weights does not take.  The
landmark arrays' bulk ops agree: the 1.0 and 2.0 MB all-gathers of the
means and covariances at 8 x 256 particles, and the halo's 0.125 / 0.125 /
0.25 / 0.25 MB shifts.

Prints one JSON line, with the card's name and power limit::

    python -m fastslam_tpu_torch.probes.collective_bytes [--devices 8] \\
        [--per-device 8192] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import init_state, pad_measurements
from fastslam_tpu_torch.parallel.collectives import tally
from fastslam_tpu_torch.parallel.mesh import make_mesh, shard_state
from fastslam_tpu_torch.parallel.ring_resample import ring_halo_resample
from fastslam_tpu_torch.parallel.sharded import make_sharded_step

MEASUREMENTS = [(2.0, 0.3), (3.5, -0.7)]   # the script's (:112)
SCALAR_BYTES = 256
RESAMPLERS = ("gspmd_resample", "halo_resample", "ring_resample")
NO_RESAMPLE, FORCED = 0.0, 2.0             # Neff < frac P: never, always


def summarize(ops) -> dict:
    """The script's keys (``:117-125``) of a list of tallied ops."""
    scalar = [o for o in ops if o["bytes"] <= SCALAR_BYTES]
    bulk = [o for o in ops if o["bytes"] > SCALAR_BYTES]
    return {
        "collective_ops": len(ops),
        "scalar_ops": len(scalar),
        "scalar_bytes": sum(o["bytes"] for o in scalar),
        "bulk_ops": [{"op": o["op"], "mbytes": round(o["bytes"] / 2**20, 3)} for o in bulk],
        "bulk_bytes_total_mb": round(sum(o["bytes"] for o in bulk) / 2**20, 3),
    }


def by_site(ops) -> dict:
    """Bytes per site (``step`` for ops outside any)."""
    out: dict = {}
    for o in ops:
        key = o["site"] or "step"
        out[key] = out.get(key, 0) + o["bytes"]
    return out


def whole_state_bytes(ops) -> int:
    """The bytes of the whole-state gather: the ``all_gather`` ops of the
    ``whole_state`` site."""
    return sum(o["bytes"] for o in ops if o["site"] == "whole_state" and o["op"] == "all_gather")


def resampler_ops(name: str, devices: int, per_device: int, landmarks: int,
                  measurements: int, device, seed: int = 0):
    """``(no_resample ops, resample ops)`` of one resampler."""
    p = devices * per_device
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=landmarks,
                         max_measurements=measurements, parity_mode=False,
                         distributed_resample=name == "halo_resample")
    mesh = make_mesh(cfg, [device] * devices)
    ms = pad_measurements(cfg, MEASUREMENTS, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = kernels.draw(gen, p)
    state = init_state(cfg, device)

    def tick(frac):
        step = make_sharded_step(cfg.replace(resample_threshold_frac=frac), mesh)
        shards = shard_state(state, mesh, cfg)
        with tally() as ops:
            shards, _ = step(shards, 0.0, 0.4, ms, draws)
        return shards, ops

    shards, quiet = tick(NO_RESAMPLE)
    if name == "ring_resample":
        with tally() as ops:
            ring_halo_resample(shards, draws.u0, mesh, cfg)
        return quiet, ops
    _, forced = tick(FORCED)
    rest = [o for o in forced if o["site"] is None]
    if [(o["op"], o["bytes"]) for o in rest] != [(o["op"], o["bytes"]) for o in quiet]:
        raise AssertionError(f"{name}: the forced tick's other ops differ from the quiet tick's")
    return quiet, [o for o in forced if o["site"] is not None]


def run(device="cuda", devices: int = 8, per_device: int = 8192, landmarks: int = 64,
        measurements: int = 16) -> dict:
    """Every resampler's ops; returns the record."""
    from fastslam_tpu_torch.eval.oracle_ate import check_device
    from fastslam_tpu_torch.probes import device_fields

    device = check_device(device)
    out = {"devices": devices, "particles": per_device * devices, "landmarks": landmarks,
           "shards_of": "one card" if device.type == "cuda" else "the CPU"}
    for name in RESAMPLERS:
        quiet, resample = resampler_ops(name, devices, per_device, landmarks, measurements,
                                        device)
        both = quiet + resample
        out[name] = summarize(both) | {
            "by_site": by_site(both), "whole_state_bytes": whole_state_bytes(both),
            "branches": {"no_resample": summarize(quiet), "resample": summarize(resample)}}
    return out | device_fields(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fastslam_tpu_torch.probes.collective_bytes")
    ap.add_argument("--devices", type=int, default=8, help="shards of the mesh")
    ap.add_argument("--per-device", type=int, default=8192, help="particles per shard")
    ap.add_argument("--landmarks", type=int, default=64)
    ap.add_argument("--measurements", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.devices, args.per_device, args.landmarks,
                         args.measurements)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
