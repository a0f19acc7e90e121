"""Tracing and timing.

Counterpart of ``fastslam_tpu/utils/profiling.py``:

* :class:`PhaseTimer`: wall-clock phase accounting for the host loop, with
  a device synchronization before the end stamp when a phase hands it CUDA
  tensors (PyTorch returns before the card finishes, so without it every
  phase looks free and the next one pays);
* :func:`device_trace`: ``torch.profiler`` over the CPU and, where there is
  a card, CUDA activities, exported as a Chrome trace;
* :func:`annotate`: a named region (``torch.profiler.record_function``)
  that shows in those traces.

* :class:`EventMarks`: stage ends marked inside a device computation, to
  split its time by stage (CUDA events on a card).

Also :func:`elapsed_ms`, the time of a function with CUDA events on a card
(host clock on the CPU), and :func:`card`, the card's name and power limit
as ``nvidia-smi`` reads them, which every device number is reported beside.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch


def _has_cuda_tensor(args) -> bool:
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return True
        if isinstance(a, (list, tuple)) and _has_cuda_tensor(a):
            return True
    return False


class PhaseTimer:
    """Accumulates per-phase wall time across loop iterations."""

    def __init__(self, sync: bool = True):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def phase(self, name: str, *sync_args):
        """Time a phase; when ``sync_args`` hold a CUDA tensor (or lists or
        tuples of them), synchronize the card before stamping the end."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and _has_cuda_tensor(sync_args):
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            out[name] = {
                "total_s": round(total, 4),
                "count": n,
                "mean_ms": round(total / max(n, 1) * 1e3, 3),
            }
        return out

    def report(self) -> str:
        lines = [f"{'phase':<20} {'total s':>10} {'count':>8} {'mean ms':>10}"]
        for name, row in self.summary().items():
            lines.append(
                f"{name:<20} {row['total_s']:>10.3f} {row['count']:>8d} "
                f"{row['mean_ms']:>10.3f}"
            )
        return "\n".join(lines)


class EventMarks:
    """Stage ends of a computation on one device: each call ``marks(name)``
    ends stage ``name``, which began at the previous mark (or at
    :meth:`start`).  CUDA events on a card (the device's time, and nothing
    waits for them), the host clock on the CPU.  :meth:`stage_ms` sums each
    stage's milliseconds over its occurrences."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self._marks: list = []

    def _stamp(self):
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def start(self) -> None:
        """Begin a stage without ending one."""
        self._marks.append((None, self._stamp()))

    def __call__(self, name: str) -> None:
        self._marks.append((name, self._stamp()))

    def stage_ms(self) -> Dict[str, float]:
        """Milliseconds per stage name, summed (synchronizes the card)."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        out: Dict[str, float] = defaultdict(float)
        for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
            if name is not None:
                out[name] += a.elapsed_time(b) if cuda else (b - a) * 1e3
        return dict(out)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU activities, and CUDA
    ones where there is a card) and write ``logdir/trace.json`` (Chrome
    trace format: Perfetto or ``chrome://tracing``).  Yields the profiler,
    whose ``key_averages()`` sums time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region visible in :func:`device_trace` traces."""
    return torch.profiler.record_function(name)


def elapsed_ms(fn, device: torch.device | str) -> float:
    """Milliseconds ``fn()`` takes: CUDA events around it on a card (the
    device's time, whatever the host does meanwhile), the host clock on the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def card(index: int = 0) -> Tuple[str, Optional[float]]:
    """``(name, power limit in W)`` of a card, from ``nvidia-smi
    --query-gpu=name,power.limit`` (the limit is None where the tool reports
    none).  Raises without the tool."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = (s.strip() for s in out.strip().splitlines()[0].rsplit(",", 1))
    try:
        return name, float(limit)
    except ValueError:
        return name, None


def sm_clock_mhz(index: int = 0) -> Optional[float]:
    """The card's current SM clock in MHz from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    try:
        return float(out.strip().splitlines()[0])
    except ValueError:
        return None
