"""The rows the program keeps of its fused online tick while a profiler
session is active (``fastslam_tpu_torch.utils.profiling.TICK_TRACE``), for
the metric readers of the online cells.

A row per tick holds its host spans ``(name, parent, start_ns, end_ns)``
(``tick``, and its children ``estimator``, ``submit``, ``wait``), the
device stage milliseconds (``icp``, ``frontend``, ``update``,
``resample``) and the counters (``icp_iters``, ``resample_due``).  Only the
window runs under the profiler, so its rows are the window's ticks.  A
program without the recorder, a cell that is not online, or a row count
other than the window's tick count gives nothing.
"""

from __future__ import annotations

import statistics


def rows(ctx: dict):
    """The window's rows, or None."""
    if ctx.get("kind") != "online" or not ctx.get("ticks"):
        return None
    from fastslam_tpu_torch.utils import profiling

    recorder = getattr(profiling, "TICK_TRACE", None)
    if recorder is None:
        return None
    kept = recorder.rows()
    return kept if len(kept) == ctx["ticks"] else None


def span_ms(ctx: dict, name: str):
    """Mean host milliseconds per tick in span ``name`` (its pieces in a
    tick summed), or None where no tick has it."""
    kept = rows(ctx)
    if kept is None or not any(s[0] == name for r in kept for s in r["spans"]):
        return None
    return 1e-6 * statistics.fmean(sum(t1 - t0 for n, _, t0, t1 in r["spans"] if n == name)
                                   for r in kept)


def stage_ms(ctx: dict, name: str):
    """Mean device milliseconds per tick of stage ``name``, or None where a
    tick lacks it."""
    return _mean(ctx, "stages", name)


def counter(ctx: dict, name: str):
    """Mean per tick of counter ``name``, or None where a tick lacks it."""
    return _mean(ctx, "counters", name)


def _mean(ctx: dict, part: str, name: str):
    kept = rows(ctx)
    if kept is None or not all(name in r[part] for r in kept):
        return None
    return statistics.fmean(r[part][name] for r in kept)
