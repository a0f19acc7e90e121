"""The device-memory copy probe, the counterpart of ``scripts/bench_hbm_floor.py``.

``out = in + 1`` over the fused update's buffer set, six ``[L, P]`` planes
and one ``[1, P]`` row, in one launch of the copy kernel
(:func:`~fastslam_tpu_torch.core.cuda_kernels.hbm_copy`); ``k`` calls are
chained, each fed the last one's outputs, and timed together with CUDA
events.  If the fused update at M = 0..1 takes about as long, it runs at the
card's copy floor::

    python -m fastslam_tpu_torch.probes.hbm_floor [--particles 100000] \\
        [--landmarks 64] [--k 20] [--device cuda]

prints one JSON line: the script's ``copy_ms`` (per call), ``gbps`` (bytes
read and written per second, in 1e9) and ``tile`` (floats per buffer that one
block moves), and ``geometry``, ``device`` and ``power_limit_w``.  The
particle count is used as given: nothing is padded.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.probes import device_fields
from fastslam_tpu_torch.utils.profiling import annotate, elapsed_ms


def copy_bytes(particles: int, landmarks: int) -> int:
    """Bytes one call reads and writes: the six planes and the row, each
    read once and written once."""
    return 2 * (6 * landmarks * particles + particles) * 4


def run(particles: int = 100_000, landmarks: int = 64, k: int = 20,
        device: torch.device | str = "cuda") -> dict:
    """Time ``k`` chained copies after a warm-up chain; returns the JSON
    fields."""
    device = torch.device(device)
    l, p = landmarks, particles
    buffers = [torch.full((l, p), float(i), device=device) for i in range(6)]
    buffers.append(torch.zeros((1, p), device=device))
    holder = [buffers]

    def chain():
        for _ in range(k):
            holder[0] = cuda_kernels.hbm_copy(holder[0])

    chain()   # warm-up: the first call builds the kernels
    with annotate("hbm_copy chain"):
        ms = elapsed_ms(chain, device) / k
    return {"copy_ms": ms, "gbps": copy_bytes(p, l) / (ms * 1e-3) / 1e9,
            "tile": cuda_kernels.HBM_COPY_TILE,
            "geometry": {"L": l, "P": p, "k": k}, **device_fields(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--landmarks", type=int, default=64)
    ap.add_argument("--k", type=int, default=20, help="chained calls timed together")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.particles, args.landmarks, args.k, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
