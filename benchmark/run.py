"""Run one cell of the benchmark and print its result as the last line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell's configuration, traffic, limits and
metric readers are found by name (:mod:`benchmark.harness`); the traffic's
driver sets the program up, measures for ``--seconds`` and checks what the
window produced against the plain reference.  With ``--trace 0`` the line
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, the device's busy seconds and a breakdown.  Without the cards the
cell asks for, or with JAX or the JAX package loaded once the window has
closed, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import harness


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = harness.cuda_device(cell.chips)
    harness.log_setup("imports and card")
    outcome = harness.driver_module(cell).run(cell, args.seed, args.seconds,
                                              bool(args.trace), device)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    line = harness.result_line(cell, device, outcome, bool(args.trace))
    harness.report_checks(outcome)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
