"""What every cell shares: the benchmark's files found by name, the card,
the set-up clock, the metric readers, the checks and the result line.

``BENCHMARK.json`` names each cell's configuration and traffic.  The
harness finds

* the configuration at the ``file`` its entry gives
  (``benchmark/configs/<config>.json``);
* the traffic at ``benchmark/traffic/<traffic>.json``, whose ``driver``
  names the module under ``benchmark/drivers/`` that runs it;
* the limits of the cell's comparison at ``benchmark/limits/<cell>.json``;
* each per-layer metric's reader at ``benchmark/metrics/<metric>.py``, a
  function ``read(ctx)`` that returns a number or None.

A new cell, mix or metric is new files and new entries: nothing here
names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run (compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fastslam_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of its
    start (``/proc/self/stat``), so interpreter start and imports count."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def log_setup(phase: str) -> None:
    """The process's age at the end of a set-up phase, on stderr."""
    print(f"setup {phase}: {process_age_s():.3f} s", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    spec: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])


def metric_applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` and the files it names."""
    bench = load_json(root / "BENCHMARK.json")
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == spec["config"])
    return Cell(
        name=name, spec=spec,
        config=load_json(root / conf["file"]),
        traffic=load_json(HERE / "traffic" / f"{spec['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if metric_applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if metric_applies(m, name)],
    )


def window_seconds(cell: Cell, seconds: float, trace: bool) -> float:
    """The window's length: ``--seconds``, or with ``--trace 1`` at most the
    traffic's ``trace_seconds``, which keeps the profiler's events, and the
    time and memory to read them, bounded."""
    return min(seconds, float(cell.traffic["trace_seconds"])) if trace else seconds


def driver_module(cell: Cell):
    return importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")


def metric_reader(name: str):
    """``read`` of ``benchmark/metrics/<name>.py`` (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cuda_device(chips: int):
    """The card, or an exit without a result where there are fewer cards
    than the cell asks for."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        raise SystemExit(3)
    # float32 stays float32: no TF32 in any product, the program's or the reference's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def forbidden_loaded() -> list:
    """Modules whose top-level name is one of :data:`FORBIDDEN_MODULES`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


@dataclass
class Check:
    """One number of the comparison beside its limit (``value <= limit``)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back from one run."""

    attempted: int
    failed: int
    end_to_end: dict                 # metric name -> value
    checks: list                     # [Check]
    memory_peak_bytes: int
    ctx: dict = field(default_factory=dict)     # what the metric readers read
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None


def device_record(device, outcome: Outcome, trace: bool) -> dict:
    import torch

    rec = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if trace:
        rec.update(busy_s=outcome.busy_s, window_s=outcome.window_s)
    return rec


def result_line(cell: Cell, device, outcome: Outcome, trace: bool) -> dict:
    """The last line of a run: end-to-end metrics with ``--trace 0``,
    per-layer metrics with ``--trace 1``; the checks last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"])(outcome.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
    line = {
        "correct": all(c.ok for c in outcome.checks) and outcome.failed == 0,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device_record(device, outcome, trace),
    }
    if trace and outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def report_checks(outcome: Outcome) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr, flush=True)
