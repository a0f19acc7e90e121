"""Ceiling probes of the card: what it sustains for the device-memory copy
(:mod:`~fastslam_tpu_torch.probes.hbm_floor`), the shared-memory stream and
the FP32 FMA rate (:mod:`~fastslam_tpu_torch.probes.vpu_roofline`), the
counterparts of ``scripts/bench_hbm_floor.py`` and
``scripts/bench_vpu_roofline.py``; and the ring resampler across processes
(:mod:`~fastslam_tpu_torch.probes.check_ring_resample`), the counterpart of
``scripts/check_ring_resample.py``.  Each is a command that prints one JSON
line; on ``--device cpu`` it runs the kernels' plain versions and reports
``"device": "cpu"``.
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
