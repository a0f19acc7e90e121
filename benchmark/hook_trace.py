"""The rows the program keeps of its production hooks while a profiler
session is active (``fastslam_tpu_torch.utils.profiling.HOOK_TRACE``), for
the metric readers of the hooked online cell.

A row per tick holds the host spans ``(name, parent, start_ns, end_ns)``
of the hooks that ran (``hook``, and its children ``health``, ``metrics``,
``serialize``, ``checkpoint``) and the counters (``checkpoint_bytes`` and
``snapshot_landmarks`` on the ticks that wrote one, the running
``health_failed``, ``recoveries``, ``last_checkpoint_tick`` and
``last_snapshot_tick``).  Only the window runs under the profiler, so its
rows are the window's ticks.  A program without the recorder, a cell that
is not online, or a row count other than the window's tick count gives
nothing.
"""

from __future__ import annotations

import statistics


def rows(ctx: dict):
    """The window's rows, or None."""
    if ctx.get("kind") != "online" or not ctx.get("ticks"):
        return None
    from fastslam_tpu_torch.utils import profiling

    recorder = getattr(profiling, "HOOK_TRACE", None)
    if recorder is None:
        return None
    kept = recorder.rows()
    return kept if len(kept) == ctx["ticks"] else None


def span_ms(ctx: dict, name: str):
    """Mean host milliseconds of span ``name`` over the ticks that ran it,
    or None where none did."""
    kept = rows(ctx)
    spans = [t1 - t0 for r in kept or () for n, _, t0, t1 in r["spans"] if n == name]
    return 1e-6 * statistics.fmean(spans) if spans else None


def span_total_s(ctx: dict, name: str):
    """Host seconds in span ``name`` over the window, or None without rows."""
    kept = rows(ctx)
    if kept is None:
        return None
    return 1e-9 * sum(t1 - t0 for r in kept for n, _, t0, t1 in r["spans"] if n == name)


def counter_mean(ctx: dict, name: str):
    """Mean of counter ``name`` over the ticks that carry it, or None."""
    kept = rows(ctx)
    values = [r["counters"][name] for r in kept or () if name in r["counters"]]
    return statistics.fmean(values) if values else None
