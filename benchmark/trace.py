"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

The harness wraps its window in one profiler session and marks its own
host phases with ``record_function("bench.<phase>")``.  After the window the
Chrome trace is written into the run's temporary directory, read, and
deleted.  From it come

* ``busy_s``: the union of the intervals in which a kernel, copy or set ran
  on the device, inside the window (the span of ``bench.window``);
* ``device_ops``: device time by operation name, the ten largest;
* ``idle_gaps``: the ten longest gaps between device operations, each
  named by the innermost ``bench.`` phase the host was in at the gap's
  midpoint.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


@contextlib.contextmanager
def profiled(enabled: bool):
    """A profiler session over the block (CPU and CUDA), or nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def phases(enabled: bool):
    """``record_function`` when tracing, else a no-op context per phase."""
    if enabled:
        import torch

        return torch.profiler.record_function
    return lambda _name: contextlib.nullcontext()


def events(prof) -> list:
    """The trace's complete events, through a file in the temporary
    directory that is removed at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its trailing argument list, at most
    ``width`` characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:width]


def union(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def summarize(evs: list) -> dict:
    """``window_s``, ``busy_s``, the device intervals (microseconds) and the
    breakdown of a trace's events."""
    window = [e for e in evs if e.get("name") == WINDOW]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    device = []
    by_name = defaultdict(float)
    for e in evs:
        if e.get("cat") in DEVICE_CATS:
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append((a, b))
                by_name[short_name(e["name"])] += (b - a) * 1e-6
    device.sort()
    gaps = []
    end = w0
    for a, b in device + [(w1, w1)]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                     for e in evs if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith("bench.") and e["name"] != WINDOW))

    def host_phase(t: float) -> str:
        inner = [(b - a, name) for a, b, name in spans if a <= t <= b]
        return min(inner)[1] if inner else "outside bench phases"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": union(device) * 1e-6,
        "device_intervals": device,
        "breakdown": {
            "device_ops": [[name, s] for name, s in top],
            "idle_gaps": [[host_phase((a + b) / 2), (b - a) * 1e-6] for a, b in longest],
        },
    }
