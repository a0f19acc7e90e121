"""The readings that the hooked cell's file limits are set from.

    python3 -m benchmark.control_hooks --workload online-hooks-fs2-icp-100k --seeds 1,2,3 --seconds 2 [--faults]

For each seed, in one process: a short window of the cell at its own size
(it closes at the first checkpoint after ``--seconds``), then the numbers
its hooks' files are compared by, for

* ``program``: the program's own files (the sound run);
* with ``--faults``, the program with a fault planted in its hooks
  (:data:`FAULTS`, through :func:`planted`), each in a window of its own:
  the checkpoint's state rounded to bfloat16 and the snapshot's map rounded
  to bfloat16 (the nearest precision below the configuration's float32),
  the snapshot one period old, the checkpoint cut short, the metrics log cut
  short, a snapshot every 20 ticks and a checkpoint every 400 (every other
  one left out).

The sampled ticks' numbers are ``online-fs2-icp-100k``'s, whose limits this
cell keeps (``benchmark/control.py``).  Prints one JSON line per seed and
reading.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import torch

from benchmark import harness


def checkpoint_bfloat16(save):
    """The checkpoint's floating-point state rounded to bfloat16 (kept in
    its own dtype)."""
    def write(path, state, **kw):
        rounded = {k: v.to(torch.bfloat16).to(v.dtype) for k, v in state.__dict__.items()
                   if v.is_floating_point()}
        return save(path, state.replace(**rounded), **kw)
    return write


def checkpoint_truncated(save):
    """The checkpoint cut to half its bytes after its atomic write."""
    def write(path, *args, **kw):
        out = save(path, *args, **kw)
        os.truncate(path, os.path.getsize(path) // 2)
        return out
    return write


def snapshot_bfloat16(serialize):
    """The snapshot's global map rounded to bfloat16."""
    def write(est, gt, poses, landmarks, *args, **kw):
        rounded = torch.tensor(list(landmarks), dtype=torch.float32).reshape(-1, 2)
        rounded = rounded.to(torch.bfloat16).to(torch.float32).tolist()
        return serialize(est, gt, poses, [tuple(c) for c in rounded], *args, **kw)
    return write


def snapshot_stale(serialize):
    """Each snapshot writes the one before it: the file on disk is one
    period old."""
    held = []

    def write(*args, **kw):
        held.append((args, kw))
        if len(held) > 1:
            args, kw = held.pop(0)
        return serialize(*args, **kw)
    return write


def doubled(every: str):
    """The hooks built with twice their ``every`` ticks between writes."""
    def breaker(init):
        def build(self, *args, **kw):
            init(self, *args, **kw)
            setattr(self, every, 2 * getattr(self, every))
        return build
    return breaker


def metrics_truncated(close):
    """The metrics log cut to half its bytes when it closes."""
    def shut(self):
        f = self._f
        close(self)
        if f is not None:
            os.truncate(f.name, os.path.getsize(f.name) // 2)
    return shut


# fault -> (module path, attribute, breaker)
FAULTS = {
    "checkpoint_bfloat16": ("fastslam_tpu_torch.app.runner", "save_checkpoint",
                            checkpoint_bfloat16),
    "snapshot_bfloat16": ("fastslam_tpu_torch.app.runner", "serialize_tick",
                          snapshot_bfloat16),
    "snapshot_stale": ("fastslam_tpu_torch.app.runner", "serialize_tick", snapshot_stale),
    "checkpoint_truncated": ("fastslam_tpu_torch.app.runner", "save_checkpoint",
                             checkpoint_truncated),
    "metrics_truncated": ("fastslam_tpu_torch.utils.logging_utils", "MetricsLog.close",
                          metrics_truncated),
    "snapshot_sparse": ("fastslam_tpu_torch.app.runner", "ProductionHooks.__init__",
                        doubled("serialize_every")),
    "checkpoint_skipped": ("fastslam_tpu_torch.app.runner", "ProductionHooks.__init__",
                           doubled("checkpoint_every")),
}


@contextlib.contextmanager
def planted(fault: str | None):
    """The program's hook writer replaced by ``fault``'s broken form for the
    block (nothing for ``None``)."""
    if fault is None:
        yield
        return
    import importlib

    module, attr, breaker = FAULTS[fault]
    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    real = getattr(owner, name)
    setattr(owner, name, breaker(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def read_seed(cell, seed, seconds, device, *, fault=None, overrides=None) -> dict:
    """One seed's readings of the hooks' files, with ``fault`` planted."""
    from benchmark.drivers import online_hooks as driver

    with planted(fault):
        hrun = driver.HooksRun(cell, seed, device, overrides=overrides)
        try:
            hrun.setup(seconds)
            hrun.window(seconds, False)
            hrun.hooks.close()
            hrun.free()
            readings = hrun.hook_readings()
        finally:
            hrun.close()
    return {"seed": seed, "fault": fault, "ticks": hrun.t - hrun.first, **readings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control_hooks")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = harness.cuda_device(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        print(json.dumps(read_seed(cell, seed, args.seconds, device)), flush=True)
    if args.faults:
        for fault in FAULTS:
            for seed in seeds[:3]:
                print(json.dumps(read_seed(cell, seed, args.seconds, device, fault=fault)),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
