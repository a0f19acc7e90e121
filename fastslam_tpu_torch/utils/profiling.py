"""Tracing and timing.

Counterpart of ``fastslam_tpu/utils/profiling.py``:

* :class:`PhaseTimer`: the host loop's phase totals and, while a
  ``torch.profiler`` session is active, rows of nested host spans, one row
  per tick, each span also a named region of the trace;
  :data:`TICK_TRACE` is the fused online tick's, :data:`HOOK_TRACE` the
  online loop's production hooks';
* :func:`device_trace`: ``torch.profiler`` over the CPU and, where there is
  a card, CUDA activities, exported as a Chrome trace;
* :func:`annotate`: a named region (``torch.profiler.record_function``)
  that shows in those traces.

* :class:`EventMarks`: stage ends marked inside a device computation, to
  split its time by stage (CUDA events on a card), with a form that a CUDA
  graph can capture, and device counters read back with the computation's
  result.

Also :func:`elapsed_ms`, the time of a function with CUDA events on a card
(host clock on the CPU), and :func:`card`, the card's name and power limit
as ``nvidia-smi`` reads them, which every device number is reported beside.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# rows kept by a PhaseTimer: the newest ticks, ~30 s of the online loop
ROW_CAPACITY = 16_384
_NOTHING = contextlib.nullcontext()


def profiling_active() -> bool:
    """Whether a ``torch.profiler`` session is active (the flag the autograd
    profiler sets while one is)."""
    return torch.autograd.profiler._is_profiler_enabled


class PhaseTimer:
    """Host-clock phases of a loop.

    :meth:`phase` adds a phase's seconds to ``totals`` on every call, and
    while a profiler session is active it is also the trace region
    ``<prefix>.<name>``.

    :meth:`row` opens the row of one tick, where a profiler session is
    active (read once, there), as the span ``tick`` (or ``name``).  Each :meth:`span`
    inside it is a child of the innermost open span: the row keeps it as ``(name,
    parent, start_ns, end_ns)`` on ``time.perf_counter_ns``, and the trace
    shows it as the region ``<prefix>.<path>`` (``fastslam.tick.submit``).
    A span's self time is its duration less its children's.  :meth:`note`
    adds the tick's device stage milliseconds and counters to the open row.
    Outside an open row :meth:`span` and :meth:`note` do nothing, so with
    no profiler session a span site costs one attribute read.

    Closed rows go into a buffer of the newest :data:`ROW_CAPACITY`;
    ``dropped`` counts the rows pushed out of it.
    """

    def __init__(self, prefix: str = "fastslam"):
        self.prefix = prefix
        self.totals: Dict[str, float] = defaultdict(float)
        self.dropped = 0
        self._rows: deque = deque(maxlen=ROW_CAPACITY)
        self._row: Optional[dict] = None
        self._open: List[str] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a phase into ``totals`` (a trace region while profiling)."""
        t0 = time.perf_counter()
        try:
            with annotate(f"{self.prefix}.{name}") if profiling_active() else _NOTHING:
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0

    def row(self, key, name: str = "tick"):
        """The row of one tick, keyed ``key`` and spanned as ``name``, where a
        profiler session is active; else nothing."""
        if not profiling_active():
            return _NOTHING
        return self._row_span(key, name)

    @contextlib.contextmanager
    def _row_span(self, key, name):
        row = self._row = {"key": key, "spans": [], "stages": {}, "counters": {}}
        try:
            with self._span(name):
                yield
        finally:
            self._row = None
        # a tick that raised keeps no row
        if len(self._rows) == self._rows.maxlen:
            self.dropped += 1
        self._rows.append(row)

    @property
    def recording(self) -> bool:
        """Whether a row is open."""
        return self._row is not None

    def span(self, name: str):
        """A child span of the innermost open one; nothing outside a row."""
        if self._row is None:
            return _NOTHING
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        parent = self._open[-1] if self._open else None
        self._open.append(name)
        label = f"{self.prefix}.{'.'.join(self._open)}"
        t0 = time.perf_counter_ns()
        try:
            with annotate(label):
                yield
        finally:
            self._row["spans"].append((name, parent, t0, time.perf_counter_ns()))
            self._open.pop()

    def note(self, stages: Dict[str, float], counters: Dict[str, float]) -> None:
        """The open row's device stage milliseconds and counters."""
        if self._row is not None:
            self._row["stages"].update(stages)
            self._row["counters"].update(counters)

    def rows(self) -> List[dict]:
        """The kept rows, oldest first: ``{"key", "spans", "stages",
        "counters"}`` each."""
        return list(self._rows)

    def clear(self) -> None:
        """Forget the kept rows and the drop count."""
        self._rows.clear()
        self.dropped = 0


# the fused online tick's spans, stage marks and counters
# (``app/runner.py:SLAMRunner.tick_fused``); one per process, so the rows of
# a profiled window can be read after the loop and its runner are gone
TICK_TRACE = PhaseTimer("fastslam")

# the online loop's production hooks (``app/runner.py:ProductionHooks``): a
# row ``hook`` per tick, each hook that ran a span ``fastslam.hook.<name>`` of
# it, and the hooks' counters
HOOK_TRACE = PhaseTimer("fastslam")


class EventMarks:
    """Stage ends of a computation on one device: each call ``marks(name)``
    ends stage ``name``, which began at the previous mark (or at
    :meth:`start`).  CUDA events on a card (the device's time, and nothing
    waits for them), the host clock on the CPU.  :meth:`stage_ms` sums each
    stage's milliseconds over its occurrences.

    With ``stages`` named in advance, in order, the marks are capture-safe:
    one event per stage end and one for the start, made once and
    ``external``, so a CUDA graph that captures the marks records them again
    at every replay.  :meth:`stage_ms` then gives the last recording of each
    stage and synchronizes nothing: read it once the computation is known
    to be done (after the read-back of its result).

    :meth:`count` keeps a device value of the computation (a tensor), for
    the caller to read back with its result."""

    def __init__(self, device: torch.device | str, stages: Optional[Sequence[str]] = None):
        self.device = torch.device(device)
        self.stages = None if stages is None else tuple(stages)
        self.counters: Dict[str, torch.Tensor] = {}
        self._marks: list = []
        self._ends: dict = {}
        if self.stages is not None and self.device.type == "cuda":
            self._ends = {name: torch.cuda.Event(enable_timing=True, external=True)
                          for name in (None, *self.stages)}

    def _stamp(self):
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def _mark(self, name: Optional[str]) -> None:
        if self.stages is None:
            self._marks.append((name, self._stamp()))
        elif self.device.type == "cuda":
            self._ends[name].record()
        else:
            self._ends[name] = time.perf_counter()

    def start(self) -> None:
        """Begin a stage without ending one."""
        self._mark(None)

    def __call__(self, name: str) -> None:
        self._mark(name)

    def count(self, name: str, value: torch.Tensor) -> None:
        """Keep the device value ``name`` of this computation."""
        self.counters[name] = value

    def stage_ms(self) -> Dict[str, float]:
        """Milliseconds per stage name, summed (synchronizes the card,
        except in the capture-safe form)."""
        cuda = self.device.type == "cuda"
        if self.stages is not None:
            e, ends = self._ends, (None, *self.stages)
            return {name: e[prev].elapsed_time(e[name]) if cuda else (e[name] - e[prev]) * 1e3
                    for prev, name in zip(ends, ends[1:])}
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
