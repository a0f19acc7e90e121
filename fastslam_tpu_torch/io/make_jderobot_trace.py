"""Record a canned JdeRobot-format HAL trace (the counterpart of
``scripts/make_jderobot_trace.py``).

The trace is recorded through the same duck-typed ``HAL`` surface the live
JdeRobot bridge uses (``drivers/jderobot_hal.SimHAL`` over ``SimWorld``), so
every byte flows through the reference's native laser-data shape.  The
recording is deterministic: the two committed traces come out byte for
byte::

    python -m fastslam_tpu_torch.io.make_jderobot_trace --check
    python -m fastslam_tpu_torch.io.make_jderobot_trace --seed 7 --y -0.3 --yaw 0.4 \\
        --range-noise 0.005 --check data/jderobot/start_seed7_300.jsonl

``--check [FILE]`` records into a temporary file and compares its bytes
with ``FILE`` (default ``data/jderobot/corridor_seed3_300.jsonl``), which it
leaves as it is; otherwise the trace goes to ``--out`` (default
``runs/jderobot/trace.jsonl``: the command never writes ``data/`` unless
told to).  Prints one JSON line, with the card's name and power limit; a
``--check`` whose bytes differ exits 1.  The recording itself is host numpy;
``--device`` (default ``cuda``, refused without a card; ``cpu`` on a machine
without one) names the device the line reports.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CORRIDOR = os.path.join(REPO, "data", "jderobot", "corridor_seed3_300.jsonl")
OUT = os.path.join("runs", "jderobot", "trace.jsonl")
# the committed traces and the flags that record them
COMMITTED = {
    "corridor_seed3_300.jsonl": {},
    "start_seed7_300.jsonl": dict(seed=7, y=-0.3, yaw=0.4, range_noise=0.005),
}


def record(path: str, ticks: int = 300, seed: int = 3, x: float = 0.0, y: float = 0.0,
           yaw: float = 0.0, range_noise: float = 0.0) -> dict:
    """Record ``ticks`` ticks of ``SimWorld(seed, x, y, yaw, range_noise)``
    through ``SimHAL`` into ``path`` and load it back; returns the ticks,
    beams and range of the loaded log."""
    from fastslam_tpu_torch.drivers.jderobot_hal import SimHAL
    from fastslam_tpu_torch.drivers.sim_world import SimWorld
    from fastslam_tpu_torch.io.jderobot_trace import load_hal_trace, record_hal_trace

    world = SimWorld(seed=seed, x=x, y=y, yaw=yaw, range_noise_std=range_noise)
    n = record_hal_trace(path, SimHAL(world), ticks)
    log = load_hal_trace(path)   # round-trip sanity
    return {"ticks": n, "beams": int(log.scans.shape[1]),
            "range": [float(log.min_range), float(log.max_range)]}


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def check(against: str, **kw) -> dict:
    """Record into a temporary file and compare its bytes with ``against``;
    returns the recording's fields with ``equal`` and both digests."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.jsonl")
        out = record(path, **kw)
        with open(path, "rb") as a, open(against, "rb") as b:
            equal = a.read() == b.read()
        return out | {"against": os.path.relpath(os.path.abspath(against), REPO),
                      "equal": equal, "sha256": _sha256(path),
                      "sha256_against": _sha256(against)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fastslam_tpu_torch.io.make_jderobot_trace")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--seed", type=int, default=3)
    # start pose + sensor noise vary the drive through the fixed room: the
    # second committed trace (start_seed7_300.jsonl) uses the accuracy
    # matrix's seed-7 start (0, -0.3, 0.4) and range noise 0.005
    ap.add_argument("--x", type=float, default=0.0)
    ap.add_argument("--y", type=float, default=0.0)
    ap.add_argument("--yaw", type=float, default=0.0)
    ap.add_argument("--range-noise", type=float, default=0.0)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--check", nargs="?", const=CORRIDOR, default=None, metavar="FILE",
                    help="compare a fresh recording with FILE byte for byte (default "
                    "the committed corridor trace) instead of writing --out")
    args = ap.parse_args(argv)

    from fastslam_tpu_torch.eval.oracle_ate import check_device
    from fastslam_tpu_torch.probes import device_fields

    fields = device_fields(check_device(args.device))
    kw = dict(ticks=args.ticks, seed=args.seed, x=args.x, y=args.y, yaw=args.yaw,
              range_noise=args.range_noise)
    if args.check:
        out = check(args.check, **kw) | fields
        print(json.dumps(out))
        if not out["equal"]:
            print(f"make_jderobot_trace: the recording differs from {args.check}",
                  file=sys.stderr)
            return 1
        return 0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = record(args.out, **kw)
    print(json.dumps(out | {"out": args.out, "sha256": _sha256(args.out)} | fields))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
