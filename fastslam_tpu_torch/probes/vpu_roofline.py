"""The on-chip stream and FMA probes, the counterpart of
``scripts/bench_vpu_roofline.py``.

* ``mul_add``: ``c = a * b + 0.9999 * c``, ``passes`` times, over ``[L, tile]``
  tiles held in shared memory (3 reads and 1 write per element and pass):
  the on-chip streaming rate a filter kernel with particle tiles staged in
  shared memory would live at
  (:func:`~fastslam_tpu_torch.core.cuda_kernels.mul_add`);
* ``fma_chain``: 8 dependent FMAs per element and pass, in registers: the
  FP32 FMA ceiling (:func:`~fastslam_tpu_torch.core.cuda_kernels.fma_chain`).

Each is timed over ``k`` chained calls (each fed the last one's output) with
CUDA events, the best of three after a warm-up::

    python -m fastslam_tpu_torch.probes.vpu_roofline [--particles 100000] \\
        [--landmarks 64] [--passes 256] [--tile 256] [--k 30] [--device cuda]

prints one JSON line with the script's keys (``geometry``,
``mul_add_pass_us``, ``mul_add_elements_per_s`` and ``fma_ops_per_s_G``, both
in 1e9 per second, ``per_LT_pass_us_at_P``, ``note``), each call's time
(``mul_add_ms``, ``fma_chain_ms``), ``device`` and ``power_limit_w``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.probes import device_fields
from fastslam_tpu_torch.utils.profiling import annotate, elapsed_ms


def _best_chain_ms(step, x, k: int, device: torch.device) -> float:
    """Milliseconds per call of ``k`` chained calls ``x = step(x)``, the
    best of three after a warm-up chain."""
    def chain():
        y = x
        for _ in range(k):
            y = step(y)

    chain()   # warm-up: the first call builds the kernels
    return min(elapsed_ms(chain, device) for _ in range(3)) / k


def run(particles: int = 100_000, landmarks: int = 64, passes: int = 256, k: int = 30,
        tile: int = 256, device: torch.device | str = "cuda") -> dict:
    """Time both probes on seeded normal planes; returns the JSON fields."""
    device = torch.device(device)
    l, p = landmarks, particles
    rng = np.random.default_rng(0)
    a, b, c = (torch.from_numpy(rng.normal(size=(l, p)).astype(np.float32)).to(device)
               for _ in range(3))
    with annotate("mul_add chain"):
        t_mul = _best_chain_ms(lambda y: cuda_kernels.mul_add(a, b, y, passes, tile),
                               c, k, device)
    with annotate("fma_chain chain"):
        t_fma = _best_chain_ms(lambda y: cuda_kernels.fma_chain(y, passes), a, k, device)
    elems = l * p
    mul_rate = passes * elems / (t_mul * 1e-3)       # elements per second
    fma_rate = passes * 8 * elems / (t_fma * 1e-3)   # FMAs per second
    return {
        "geometry": {"L": l, "P": p, "tile": tile, "passes": passes, "k": k},
        "mul_add_pass_us": t_mul * 1e3 / passes,
        "mul_add_elements_per_s": mul_rate / 1e9,
        "fma_ops_per_s_G": fma_rate / 1e9,
        "per_LT_pass_us_at_P": elems / mul_rate * 1e6,
        "mul_add_ms": t_mul,
        "fma_chain_ms": t_fma,
        "note": "mul_add = shared-memory streaming pass (3R+1W); fma_chain = FMA "
                "ceiling (dependent, register-resident)",
        **device_fields(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--landmarks", type=int, default=64)
    ap.add_argument("--passes", type=int, default=256, help="[L, tile] passes per call")
    ap.add_argument("--tile", type=int, default=256, help="columns per block")
    ap.add_argument("--k", type=int, default=30, help="chained calls timed together")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.particles, args.landmarks, args.passes, args.k, args.tile,
                         args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
