"""The checkpoint's DEFLATE encoder (``csrc/deflate.cu``) on a driven state.

The hooked online loop (``run_driver`` with a checkpoint every ``--ticks``
ticks) drives the repository's room (``SimWorld``, the room the
benchmark's online traffic freezes) with wheel slip of σ (0.02 rad,
0.02 m), fs2 + ICP + adaptive floors in production, and checkpoints at tick
``--ticks``; the probe loads that checkpoint back, in the blocks layout the
hooks write, and takes each member the encoder takes (at least
``io/checkpoint.ENCODER_MIN_BYTES``, ``checkpoint.encoder_members``):

* ``kernel_ms``: :func:`~fastslam_tpu_torch.core.cuda_kernels.deflate_fixed`
  on the member, ``--reps`` calls after a warm one, CUDA events (on the
  CPU, the plain version on the host clock);
* ``bound_ms``: the member read once and its stream written once at the
  H100's 3.35 TB/s;
* ``plain_ms``: the plain version on a CPU copy, once, host clock;
* ``equal``: the kernel's stream buffer and its length, CRC and row-match
  bytes equal the plain version's;
* ``device_us``: on the card, the device microseconds per call of each of
  the launcher's kernels (``deflate_count``, ``deflate_scan``,
  ``deflate_write``) and its memsets, from ``torch.profiler``;

and for the whole state ``np.savez_compressed`` of the same arrays on the
host (``savez_ms``, ``savez_bytes``: the writer the checkpoint had before
the encoder, less its copy to the host) and ``save_checkpoint`` of the
state where it lies, end to end (``save_ms`` per call, host clock,
``--reps`` calls; ``file_bytes``).  ``launches_in_run`` counts the kernel's
launches inside the hooked loop.  One JSON line, with the card's name and
power limit::

    python -m fastslam_tpu_torch.probes.checkpoint_deflate [--particles 100000] \\
        [--landmarks 64] [--ticks 400] [--reps 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from fastslam_tpu_torch.app.runner import run_driver
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.drivers.replay import ReplayDriver, record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.io import checkpoint
from fastslam_tpu_torch.probes import device_fields
from fastslam_tpu_torch.probes.compare import PEAK_BYTES_PER_S
from fastslam_tpu_torch.utils.profiling import elapsed_ms

SLIP = (0.02, 0.02)


def driven_checkpoint(path: str, particles: int = 100_000, landmarks: int = 64,
                      ticks: int = 400, device: torch.device | str = "cuda", seed: int = 3):
    """The hooked loop's checkpoint at tick ``ticks``, loaded on ``device``:
    ``(state, launches)``, the blocks-layout state and the encoder's
    launches during the loop."""
    cfg = FastSLAMConfig(num_particles=particles, max_landmarks=landmarks, parity_mode=False,
                         proposal_mode="fastslam2", use_icp_proposal=True,
                         adaptive_proposal_floors=True)
    log = record_log(SimWorld(seed=seed), num_ticks=ticks + 1)
    with cuda_kernels.counted() as launches:
        run_driver(ReplayDriver(log), cfg, rng=seed, device=device, checkpoint_path=path,
                   checkpoint_every=ticks, odometry_noise=SLIP)
    state, meta = checkpoint.load_checkpoint(path, device)
    assert meta["iteration"] == ticks
    return state, launches.get("deflate_fixed", 0)


def same_encoding(t: torch.Tensor, row: int) -> bool:
    """Whether the encoder on ``t`` equals the plain version on its CPU copy."""
    stream, info = cuda_kernels.deflate_fixed(t, row, 0)
    want, want_info = cuda_kernels.deflate_fixed_ref(t.cpu(), row, 0)
    return torch.equal(stream.cpu(), want) and torch.equal(info.cpu(), want_info)


def device_split(t: torch.Tensor, row: int, reps: int) -> dict:
    """Device microseconds per call of each kernel of one encoding."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            cuda_kernels.deflate_fixed(t, row, 0)
        torch.cuda.synchronize(t.device)
    split = {}
    for e in prof.key_averages():
        part = next((p for p in ("deflate_count", "deflate_scan", "deflate_write", "Memset")
                     if p in e.key), None)
        if part:
            split[part] = split.get(part, 0.0) + getattr(e, "device_time_total", 0.0) / reps
    return split


def run(particles: int = 100_000, landmarks: int = 64, ticks: int = 400, reps: int = 10,
        device: torch.device | str = "cuda") -> dict:
    device = torch.device(device)
    with tempfile.TemporaryDirectory() as d:
        state, launches = driven_checkpoint(os.path.join(d, "driven.npz"), particles,
                                            landmarks, ticks, device)
        members = {}
        for name, t, row in checkpoint.encoder_members(state):
            stream, info = cuda_kernels.deflate_fixed(t, row, 0)        # warm
            bits, _, matched = info.tolist()
            nbytes = t.nbytes
            host = t.cpu()
            t0 = time.perf_counter()
            cuda_kernels.deflate_fixed_ref(host, row, 0)
            plain_ms = (time.perf_counter() - t0) * 1e3

            def calls(t=t, row=row):    # each call's buffers freed, as between checkpoints
                for _ in range(reps):
                    cuda_kernels.deflate_fixed(t, row, 0)
            members[name] = {
                "bytes": nbytes, "stream_bytes": (bits + 7) // 8,
                "match_pct": 100.0 * matched / nbytes,
                "kernel_ms": elapsed_ms(calls, device) / reps,
                "bound_ms": (nbytes + (bits + 7) // 8) / PEAK_BYTES_PER_S * 1e3,
                "plain_ms": plain_ms, "equal": same_encoding(t, row)}
            if device.type == "cuda":
                members[name]["device_us"] = device_split(t, row, reps)
        arrays = {k: v.cpu().numpy() for k, v in state.__dict__.items() if v is not None}
        buf = io.BytesIO()
        t0 = time.perf_counter()
        np.savez_compressed(buf, **arrays)
        savez_ms = (time.perf_counter() - t0) * 1e3
        path = os.path.join(d, "ck.npz")
        save_ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            checkpoint.save_checkpoint(path, state, iteration=ticks)
            save_ms.append((time.perf_counter() - t0) * 1e3)
        file_bytes = os.path.getsize(path)
    total = lambda key: sum(m[key] for m in members.values())
    return {"members": members, "kernel_ms": total("kernel_ms"), "bound_ms": total("bound_ms"),
            "plain_ms": total("plain_ms"), "equal": all(m["equal"] for m in members.values()),
            "state_bytes": sum(a.nbytes for a in arrays.values()),
            "savez_ms": savez_ms, "savez_bytes": len(buf.getvalue()),
            "save_ms": statistics.median(save_ms), "save_ms_range": [min(save_ms), max(save_ms)],
            "file_bytes": file_bytes, "launches_in_run": launches,
            "geometry": {"P": particles, "L": landmarks, "ticks": ticks, "reps": reps},
            **device_fields(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--landmarks", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=400, help="the checkpoint's tick")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.particles, args.landmarks, args.ticks, args.reps, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
