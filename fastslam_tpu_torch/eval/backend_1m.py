"""BASELINE config #5: a >=1M-landmark pose graph built by the grid-hash
builder and optimized by the sharded Schur backend on a map mesh of the
card (the counterpart of ``scripts/bench_backend_1m.py``).

The serpentine survey world (``backend/survey.py``), the consensus
alignment and the builder run on the host (numpy); ``optimize_sharded``
runs on ``shards`` shards of the card, its segment sums in the port's
segment-sum kernel.  Writes ``eval_results/torch/backend_1m.json`` with the
seconds of each stage, peak RSS and peak device memory, the landmark and
factor counts, the dropped factors (there must be none: the run raises),
and the error trajectory, then applies the script's assertions
(``scripts/bench_backend_1m.py:286-317``), the check against the committed
``eval_results/backend_1m.json`` included::

    python -m fastslam_tpu_torch.eval.backend_1m [--landmarks 1100000] \\
        [--keyframes 1024] [--iters 8] [--shards 4] [--device cuda]

The JSON line it prints last carries the card's name and power limit.  A
broken assertion exits 1.  ``--device cpu`` runs on CPU shards (give it a
small ``--landmarks``).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np
import torch

from fastslam_tpu_torch.eval.oracle_ate import check_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(REPO, "eval_results", "torch", "backend_1m.json")
COMMITTED = os.path.join(REPO, "eval_results", "backend_1m.json")   # the JAX run's
DAMPING = 1e-3
# factor weights: the true sensor noise (scripts/bench_backend_1m.py:169-183)
GRAPH = dict(association_gate=0.5, obs_sigma_r=0.01, obs_sigma_b=1e-3,
             odo_sigma_xy=0.05, odo_sigma_theta=0.001)


def mean_error(gt, est, aligned=False) -> float:
    """Mean keyframe position error of ``est`` against ``gt``; ``aligned``
    first fits the best SE(2) (the gauge, ``eval/metrics.align_se2``)."""
    from fastslam_tpu_torch.eval.metrics import align_se2

    est = np.asarray(est.cpu() if isinstance(est, torch.Tensor) else est)[:, :2]
    if aligned:
        est = align_se2(gt[:, :2], est)
    return float(np.linalg.norm(est - gt[:, :2], axis=1).mean())


def build_graph(n_landmarks=1_100_000, k=1024, device="cuda", *, lm_capacity=1 << 21,
                factor_capacity=1 << 23):
    """The survey world of ``n_landmarks`` landmarks and ``k`` keyframes
    (seed 1), its consensus alignment, and the pose graph built from the
    drifted trajectory with association at the aligned poses, on
    ``device``.  Returns ``(graph, ground truth [K, 3], aligned poses,
    alignment info, host seconds of each stage)``."""
    from fastslam_tpu_torch.backend.alignment import consensus_align
    from fastslam_tpu_torch.backend.builder import build_pose_graph
    from fastslam_tpu_torch.backend.survey import survey_world_chunked

    t0 = time.perf_counter()
    noisy, obs, gt, _ = survey_world_chunked(n_landmarks, k=k, sigma_xy=0.05, seed=1)
    t1 = time.perf_counter()
    # association runs at the consensus-aligned poses with a tight gate; the
    # graph starts from the drifted trajectory (scripts/bench_backend_1m.py:156)
    aligned, info = consensus_align(noisy, obs, sigma_xy=0.05, sigma_theta=0.001)
    t2 = time.perf_counter()
    g = build_pose_graph(noisy, obs, association_poses=aligned, max_landmarks=lm_capacity,
                         max_factors=factor_capacity, device=device, **GRAPH)
    t3 = time.perf_counter()
    return g, gt, aligned, info, {"world": t1 - t0, "align": t2 - t1, "build": t3 - t2}


def run(n_landmarks=1_100_000, k=1024, iters=8, shards=4, device="cuda", *,
        lm_capacity=1 << 21, factor_capacity=1 << 23, marks=None, state=None) -> dict:
    """Build the survey graph (:func:`build_graph`) and optimize it on
    ``shards`` shards of ``device``; returns the script's keys (``n_devices``
    is the shard count) and ``peak_device_memory_gb`` (None on the CPU) with
    the device's name and power limit.  Raises ``ValueError`` when sharding
    drops a factor.

    ``marks`` (a :class:`~fastslam_tpu_torch.utils.profiling.EventMarks`)
    times the GN iterations' stages.  A dict passed as ``state`` receives the
    graph, its ground truth and the optimized ``poses``, ``landmarks`` and
    ``err``."""
    from fastslam_tpu_torch.backend import distributed
    from fastslam_tpu_torch.parallel.mesh import make_map_mesh
    from fastslam_tpu_torch.probes import device_fields

    device = check_device(device)
    g, gt, aligned, info, seconds = build_graph(n_landmarks, k, device,
                                                lm_capacity=lm_capacity,
                                                factor_capacity=factor_capacity)
    n_lm, n_f = int(g.lm_valid.sum()), int(g.obs_valid.sum())

    gs, dropped = distributed.shard_pose_graph(g, shards)
    if dropped:
        raise ValueError(f"{dropped} factors dropped at {shards} shards: raise "
                         f"factor_capacity ({factor_capacity})")
    err0 = distributed.total_error_host(gs.poses, gs.landmarks[:, 0], gs.landmarks[:, 1], gs)

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t4 = time.perf_counter()
    poses, landmarks, err = distributed.optimize_sharded(
        g, make_map_mesh([device] * shards), num_iters=iters, damping=DAMPING, marks=marks)
    if cuda:
        torch.cuda.synchronize(device)
    opt_s = time.perf_counter() - t4
    if state is not None:
        state.update(graph=g, gt=gt, poses=poses, landmarks=landmarks, err=err)

    return {
        "platform": device.type,
        "n_landmarks_requested": n_landmarks,
        "n_landmarks_built": n_lm,
        "n_factors": n_f,
        "lm_capacity": lm_capacity,
        "factor_capacity": factor_capacity,
        "dropped_factors": int(dropped),
        "keyframes": int(g.poses.shape[0]),
        "n_devices": shards,
        "world_gen_seconds": round(seconds["world"], 2),
        "align_seconds": round(seconds["align"], 2),
        "align_pairs_registered": info["n_registered_pairs"],
        "build_seconds": round(seconds["build"], 2),
        "optimize_seconds": round(opt_s, 2),
        "optimize_iters": iters,
        "total_error_before": err0,
        "total_error_after": float(err),
        "mean_keyframe_error_before_m": mean_error(gt, g.poses),
        "mean_keyframe_error_before_gauge_aligned_m": mean_error(gt, g.poses, True),
        "mean_keyframe_error_consensus_m": mean_error(gt, aligned),
        "mean_keyframe_error_after_m": mean_error(gt, poses),
        "mean_keyframe_error_after_gauge_aligned_m": mean_error(gt, poses, True),
        "peak_rss_gb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
        "peak_device_memory_gb": (round(torch.cuda.max_memory_allocated(device) / 1e9, 3)
                                  if cuda else None),
        **device_fields(device),
    }


def check(out: dict, committed: dict | None = None) -> list:
    """The script's assertions on a run (``scripts/bench_backend_1m.py:
    286-317``); returns the broken ones, each as a sentence.  ``committed``
    is the JAX run's artifact: the gauge-aligned error after must land
    within 0.05 + 0.25 b of its b."""
    broken = []
    after = out["mean_keyframe_error_after_gauge_aligned_m"]
    before = out["mean_keyframe_error_before_gauge_aligned_m"]
    if committed is not None:
        b = committed["mean_keyframe_error_after_gauge_aligned_m"]
        if not abs(after - b) < 0.05 + 0.25 * b:
            broken.append(f"gauge-aligned error after {after:.4f} m, the committed "
                          f"artifact's {b:.4f} m: not within 0.05 + 0.25 b")
    if out["dropped_factors"] != 0:
        broken.append(f"{out['dropped_factors']} factors dropped")
    requested, built = out["n_landmarks_requested"], out["n_landmarks_built"]
    if not (built >= 1_000_000 or requested < 1_000_000):
        broken.append(f"{built} landmarks built, under 1,000,000")
    # loop closures merged: the count within a few percent of the truth
    if abs(built - requested) > 0.03 * requested:
        broken.append(f"{built} landmarks built for {requested}: off by more than 3 %")
    if not after < 0.6 * before:
        broken.append(f"gauge-aligned error {before:.4f} -> {after:.4f} m: not under 0.6x")
    if not out["total_error_after"] < out["total_error_before"]:
        broken.append(f"total error {out['total_error_before']:.6e} -> "
                      f"{out['total_error_after']:.6e}: not down")
    return broken


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fastslam_tpu_torch.eval.backend_1m")
    ap.add_argument("--landmarks", type=int, default=1_100_000)
    ap.add_argument("--keyframes", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--committed", default=COMMITTED,
                    help="the artifact the error after is held to ('' to skip)")
    args = ap.parse_args(argv)

    out = run(args.landmarks, k=args.keyframes, iters=args.iters, shards=args.shards,
              device=args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    committed = None
    if args.committed:
        with open(args.committed) as f:
            committed = json.load(f)
    broken = check(out, committed)
    print(json.dumps(out | {"broken": broken}))
    if broken:
        print("backend_1m: " + "; ".join(broken), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
