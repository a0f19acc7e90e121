"""Command-line interface of the PyTorch/CUDA engine.

  python -m fastslam_tpu_torch record --ticks 300 --out runs/log.npz
  python -m fastslam_tpu_torch run --log runs/log.npz --chunk 16 \\
      --particles 100000 --landmarks 64 --production

``run`` executes on ``--device cuda`` unless ``--device cpu`` is given; it
stops with an error when there is no GPU rather than fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_record(args) -> int:
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld

    world = SimWorld(seed=args.seed, range_noise_std=args.range_noise)
    log = record_log(world, num_ticks=args.ticks)
    log.save(args.out)
    print(json.dumps({"ticks": len(log), "out": args.out}))
    return 0


def cmd_run(args) -> int:
    import torch

    from fastslam_tpu_torch.app.runner import replay_chunked
    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.drivers.replay import LaserLog

    if not args.chunk:
        raise NotImplementedError(
            "run without --chunk (the online run_driver loop) is not ported "
            "yet (ROADMAP.md: online loop); pass --chunk N")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    # the frontend's float32 products must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # the chunked engine runs the production math
    cfg = FastSLAMConfig(
        num_particles=args.particles, max_landmarks=args.landmarks,
        parity_mode=False, warmup_iterations=args.warmup,
    )
    log = LaserLog.load(args.log)
    hist = replay_chunked(log, cfg, chunk_size=args.chunk, rng=args.seed,
                          device=args.device)
    metrics = hist.metrics(skip=args.skip_ticks)
    metrics["device"] = args.device
    print(json.dumps(metrics))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fastslam_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("record", help="record a synthetic-world laser log")
    p.add_argument("--ticks", type=int, default=500)
    p.add_argument("--out", default="runs/log.npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--range-noise", type=float, default=0.0)
    p.set_defaults(fn=cmd_record)

    p = sub.add_parser("run", help="run SLAM on a replay log, print metrics")
    p.add_argument("--log", required=True)
    p.add_argument("--chunk", type=int, default=0,
                   help="batch replay: ticks per chunked kernel call "
                        "(production math)")
    p.add_argument("--skip-ticks", type=int, default=0,
                   help="skip first N ticks in metrics")
    p.add_argument("--particles", type=int, default=128)
    p.add_argument("--landmarks", type=int, default=32, help="per-particle capacity")
    p.add_argument("--production", action="store_true",
                   help="production math (the chunked replay always uses it)")
    p.add_argument("--warmup", type=int, default=150, help="dead-reckoning ticks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
