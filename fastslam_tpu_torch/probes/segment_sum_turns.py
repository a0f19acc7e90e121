"""The pose-graph backend's four segment sums at BASELINE config #5, timed on
the card checkout by checkout, in turns::

    python -m fastslam_tpu_torch.probes.segment_sum_turns [--reps 50] \\
        [--out FILE] TREE [TREE ...]

``TREE`` is the root of a checkout of this repository (``.`` for this one).
The command builds the 1.1M-landmark survey graph of ``chip_smoke.py``
phase 21 once, with this checkout's backend, and saves shard 0 of 4's four
sums of one sparse Gauss-Newton iteration (seeded values, the layout's
``perm`` and ``offsets``, and the plain version's sums) under
``build/segment_sum_turns/``.  Then it runs each TREE in turn in a process
of its own, which imports that tree's ``fastslam_tpu_torch`` (its kernels
built from its own ``csrc/``): each sum is held against the plain sums bit
for bit, then timed with CUDA events (:func:`replay_ms`, :func:`eager_ms`).
A layout gets the tree's own ``long_segments`` where the tree has one.
Naming trees as ``A B B A`` times two versions in turns on one card.

Prints one JSON line per tree run (the tree, the card's name and power
limit, the ptxas line of ``segment_sum_kernel``, each sum's device ms per
call from a replayed CUDA graph of ``reps`` calls, the same with the L2
cache cold before each call, and its ms per eager call), then one summary
line, which ``--out`` also writes.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

# BASELINE config #5 (tests/test_backend_scale.py:157-215) as chip_smoke.py
# phase 21 builds it
CONFIG5_LANDMARKS, CONFIG5_KEYFRAMES = 1_100_000, 1024
INPUTS = Path("build") / "segment_sum_turns" / "inputs.pt"


def config5_graph(device):
    """The 1.1M-landmark survey graph on ``device`` (``eval/backend_1m.py:
    build_graph``), its ground truth, the consensus alignment's info, and
    the host seconds of each stage."""
    from fastslam_tpu_torch.eval.backend_1m import build_graph

    g, gt, _, info, seconds = build_graph(CONFIG5_LANDMARKS, CONFIG5_KEYFRAMES, device)
    return g, gt, info, seconds


def config5_sums(g, shards, device):
    """Shard 0's four segment sums of one sparse GN iteration at this graph's
    shapes: ``(name, values, layout)`` with seeded values in the layout's
    columns (by landmark 5, by keyframe 12, by keyframe cell 9, the
    back-substitution 2)."""
    import torch

    from fastslam_tpu_torch.backend import distributed
    from fastslam_tpu_torch.parallel.mesh import make_map_mesh

    gs, _ = distributed.shard_pose_graph(g, shards)
    pair_a, pair_b, pair_valid = distributed.build_schur_pairs(gs, shards, device)
    layout = distributed.schur_layouts(
        make_map_mesh([device] * shards), g.poses.shape[0], g.landmarks.shape[0],
        gs.obs_kf, gs.obs_lm, gs.obs_valid, pair_a, pair_b, pair_valid)[0]
    gen = torch.Generator(device=device).manual_seed(21)
    f_local, cap = gs.obs_kf.shape[0] // shards, pair_a.shape[0] // shards
    cols = lambda c, n: torch.randn((c, n), generator=gen, device=device)
    return [("by_landmark", cols(5, f_local), layout.by_lm),
            ("by_keyframe", cols(12, f_local), layout.by_kf),
            ("cross", cols(9, cap), layout.by_cell),
            ("backsub", cols(2, f_local), layout.by_lm)]


def replay_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed once to warm it and once under CUDA events.  The
    calls' host work (the wrapper's checks, the launch through ctypes) is
    left out, so a kernel shorter than it is timed apart from it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cold_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` with the L2 cache cold: each call
    follows a read of 128 MB (2.5 L2 caches) in the graph, whose own time is
    taken off."""
    import torch

    sweep = torch.ones(32 << 20, device="cuda")
    flush = lambda: sweep.sum()
    return replay_ms(lambda: (flush(), fn()), reps) - replay_ms(flush, reps)


def eager_ms(fn, reps: int) -> float:
    """Ms per call of ``fn`` called ``reps`` times in turn after a warm-up,
    under CUDA events: the card's time, or the host's where the calls'
    host work is the longer."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ptxas_line(log: str) -> str:
    """The ptxas report's registers, spills and shared memory of
    ``segment_sum_kernel``."""
    inside, found = False, []
    for line in log.splitlines():
        if "entry function" in line:
            inside = "segment_sum_kernel" in line
        elif inside and re.search(r"spill|Used \d+ registers", line):
            found.append(line.split(":", 1)[-1].strip())
    return "; ".join(found) or "n/a"


def time_tree(path: str, reps: int) -> dict:
    """In a tree's own process: each saved sum bit for bit against the plain
    sums, then its device ms per call (:func:`replay_ms`) and its ms per
    eager call (:func:`eager_ms`)."""
    import torch

    from fastslam_tpu_torch.core import _build, cuda_kernels

    saved = torch.load(path, map_location="cuda")
    device_ms, cold, eager = {}, {}, {}
    for name, values, perm, offsets, want in saved:
        layout = cuda_kernels.Segments(perm, offsets)
        if hasattr(cuda_kernels, "long_segments"):
            layout = layout._replace(long=cuda_kernels.long_segments(offsets))
        got = cuda_kernels.segment_sum(values, layout)
        if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
            raise AssertionError(f"{name}: {int((got != want).sum())} sums differ from the "
                                 f"plain version's")
        call = lambda: cuda_kernels.segment_sum(values, layout)
        device_ms[name], cold[name] = replay_ms(call, reps), cold_ms(call, reps)
        eager[name] = eager_ms(call, reps)
    log = _build.library_path().with_suffix(".log")
    return {"ptxas": ptxas_line(log.read_text()) if log.exists() else "n/a",
            "ms": device_ms, "cold_ms": cold, "eager_ms": eager}


def gather_sectors(layout, short: int) -> dict:
    """How scattered a layout's gathers are: the distinct 32-byte sectors of
    a value column per warp load, on average, and their MB per column.  A
    long segment's warp loads 32 consecutive entries; a short tile's loads
    slot j of its 32 segments."""
    import numpy as np

    offsets = layout.offsets.cpu().numpy().astype(np.int64)
    counts = np.diff(offsets)
    seg = np.repeat(np.arange(len(counts)), counts)
    pos = np.arange(offsets[-1]) - offsets[:-1][seg]
    sector = layout.perm[:offsets[-1]].cpu().numpy().astype(np.int64) >> 3
    if not len(sector):
        return {"sectors_per_load": 0.0, "sector_mb": 0.0}
    width = int(counts.max()) // 32 + 1           # a long segment's loads
    load = np.where(counts[seg] > short, seg * width,
                    len(counts) * width + (seg // 32) * 32) + np.where(
                        counts[seg] > short, pos // 32, pos)
    pairs = load * (int(sector.max()) + 1) + sector
    loads, sectors = len(np.unique(load)), len(np.unique(pairs))
    return {"sectors_per_load": sectors / loads, "sector_mb": sectors * 32 / 1e6}


def build_inputs(path: Path) -> dict:
    """Save config #5's four sums of shard 0 of 4 with their plain sums."""
    import torch

    from fastslam_tpu_torch.core import cuda_kernels

    g, _, _, host_s = config5_graph("cuda")
    saved, shapes = [], {}
    for name, values, layout in config5_sums(g, 4, "cuda"):
        want = cuda_kernels.segment_sum_ref(values, layout)
        saved.append((name, values, layout.perm, layout.offsets, want))
        counts = layout.offsets[1:] - layout.offsets[:-1]
        shapes[name] = {"columns": values.shape[0], "entries": int(layout.offsets[-1]),
                        "segments": layout.num_segments, "empty": int((counts == 0).sum()),
                        "long": int(layout.long[0]), "longest": int(counts.max()),
                        **gather_sectors(layout, cuda_kernels.SHORT_SEGMENT)}
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, path)
    return {"host_s": host_s, "shapes": shapes}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--out", default=None)
    parser.add_argument("--time", default=None, help=argparse.SUPPRESS)  # a tree's process
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("segment_sum_turns needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.time:
        print(json.dumps(time_tree(args.time, args.reps)))
        return 0
    from fastslam_tpu_torch.utils.profiling import card

    name, limit = card(0)
    inputs = build_inputs(INPUTS.resolve())
    print(json.dumps({"device": name, "power_limit_w": limit, **inputs}), flush=True)
    runs = []
    for tree in args.trees:
        root = Path(tree).resolve()
        env = dict(os.environ, PYTHONPATH=str(root))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), tree, "--time",
                               str(INPUTS.resolve()), "--reps", str(args.reps)],
                              cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        run = {"tree": tree, "device": name, "power_limit_w": limit,
               **json.loads(proc.stdout.strip().splitlines()[-1])}
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = {"device": name, "power_limit_w": limit, "reps": args.reps, "turns": [
        {"tree": r["tree"], "ms": r["ms"], "cold_ms": r["cold_ms"], "eager_ms": r["eager_ms"]}
        for r in runs]}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs, **summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
