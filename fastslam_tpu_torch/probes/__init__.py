"""Ceiling probes of the card: what it sustains for the device-memory copy
(:mod:`~fastslam_tpu_torch.probes.hbm_floor`), the shared-memory stream and
the FP32 FMA rate (:mod:`~fastslam_tpu_torch.probes.vpu_roofline`), the
counterparts of ``scripts/bench_hbm_floor.py`` and
``scripts/bench_vpu_roofline.py``; and the ring resampler across processes
(:mod:`~fastslam_tpu_torch.probes.check_ring_resample`), the counterpart of
``scripts/check_ring_resample.py``.  Each is a command that prints one JSON
line; on ``--device cpu`` it runs the kernels' plain versions and reports
``"device": "cpu"``.  Two more commands time checkouts of this repository
in turns on the card: the backend's segment sums
(:mod:`~fastslam_tpu_torch.probes.segment_sum_turns`) and the ring across
processes (:mod:`~fastslam_tpu_torch.probes.ring_peers_turns`).  The
measurement commands time the filter: K steps in one captured CUDA graph
(:mod:`~fastslam_tpu_torch.probes.step`), the step with and without its
kernels (:mod:`~fastslam_tpu_torch.probes.compare`), the online tick's
parts (:mod:`~fastslam_tpu_torch.probes.e2e_attribution`), the sharded
step's collectives (:mod:`~fastslam_tpu_torch.probes.collective_bytes`)
and its weak scaling on shards of one card
(:mod:`~fastslam_tpu_torch.probes.scaling`); ``probes.check_parity``
holds the card's kernels to the CPU.
"""

from __future__ import annotations

import torch

from fastslam_tpu_torch.utils.profiling import card


def device_fields(device: torch.device) -> dict:
    """``{"device": name, "power_limit_w": W}`` of the card the probe ran
    on; ``{"device": "cpu", "power_limit_w": None}`` on the CPU."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    return {"device": torch.cuda.get_device_name(index), "power_limit_w": card(index)[1]}
