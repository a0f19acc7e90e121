"""The ring resampler across processes, timed on the card checkout by
checkout, in turns::

    python -m fastslam_tpu_torch.probes.ring_peers_turns [--layouts 2x2,4x1] \\
        [--reps 10] [--particles 100000] [--landmarks 64] [--exchanges 2] \\
        [--out FILE] TREE [TREE ...]

``TREE`` is the root of a checkout of this repository (``.`` for this one).
For each layout (processes x shards in each) and each TREE in turn, the
command runs that tree's ``probes/check_ring_resample.py`` from its root, so
that its processes import that tree's ``fastslam_tpu_torch`` and build its
kernels from its own ``csrc/``: every check of the probe (the resamplers bit
for bit, ``--exchanges`` exchanges against the plain one) and ``--reps``
calls per timed turn of the cross-process exchange, the plain exchange
through gloo, ``ring_halo_resample`` and the halo resampler.  Naming trees
as ``A B B A`` times two versions in turns on one card.

Prints one JSON line per run (the tree, the layout, the probe's ``ok``, each
process's ms per call and, where the tree reports them, its waits), then one
summary line, which ``--out`` also writes: per layout and tree the smallest,
largest and mean ms per call over every process and turn, the card's name
and its power limit.  A run that fails fails the command.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

TIMES = ("kernel", "plain", "ring", "halo")


def run_tree(tree: str, processes: int, shards: int, args) -> dict:
    """One run of ``tree``'s probe at ``processes`` x ``shards``."""
    root = Path(tree).resolve()
    cmd = [sys.executable, "-m", "fastslam_tpu_torch.probes.check_ring_resample",
           "--processes", str(processes), "--shards", str(shards),
           "--particles", str(args.particles), "--landmarks", str(args.landmarks),
           "--exchanges", str(args.exchanges), "--reps", str(args.reps)]
    proc = subprocess.run(cmd, cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
                          capture_output=True, text=True, timeout=args.timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} at {processes}x{shards}: exit {proc.returncode}\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return {"tree": tree, "layout": f"{processes}x{shards}", "ok": out["ok"],
            "device": out["device"], "power_limit_w": out["power_limit_w"],
            "times": out["times"], "waits": out.get("waits")}


def summarise(runs) -> dict:
    """Per layout and tree: min, max and mean ms per call of each timed
    function over every process and turn of its runs."""
    out = {}
    for run in runs:
        per = out.setdefault(run["layout"], {}).setdefault(run["tree"], {k: [] for k in TIMES})
        for process in run["times"]:
            for k in TIMES:
                per[k].extend(process[k])
    return {layout: {tree: {k: {"min": min(v), "max": max(v), "mean": sum(v) / len(v)}
                            for k, v in per.items()}
                     for tree, per in trees.items()}
            for layout, trees in out.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--layouts", default="2x2,4x1",
                        help="processes x shards in each, comma-separated")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--particles", type=int, default=100_000)
    parser.add_argument("--landmarks", type=int, default=64)
    parser.add_argument("--exchanges", type=int, default=2)
    parser.add_argument("--timeout", type=float, default=600.0,
                        help="seconds one run may take")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ring_peers_turns needs an NVIDIA GPU", file=sys.stderr)
        return 1
    runs = []
    for layout in args.layouts.split(","):
        processes, shards = map(int, layout.split("x"))
        for tree in args.trees:
            runs.append(run_tree(tree, processes, shards, args))
            print(json.dumps(runs[-1]), flush=True)
    if not all(r["ok"] for r in runs):
        raise RuntimeError("a run's checks failed")
    summary = {"device": runs[0]["device"], "power_limit_w": runs[0]["power_limit_w"],
               "reps": args.reps, "particles": args.particles, "landmarks": args.landmarks,
               "turns": [(r["layout"], r["tree"]) for r in runs], "ms": summarise(runs)}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs, **summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
