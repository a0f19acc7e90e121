"""Command-line interface of the PyTorch/CUDA engine.

  python -m fastslam_tpu_torch record --ticks 300 --out runs/log.npz
  python -m fastslam_tpu_torch run --log runs/log.npz --particles 1000
  python -m fastslam_tpu_torch run --log runs/log.npz --chunk 16 \\
      --particles 100000 --landmarks 64 --production
  python -m fastslam_tpu_torch sim --ticks 500 --particles 256
  python -m fastslam_tpu_torch sim --production --health --metrics runs/metrics.jsonl \\
      --serialize workspace/shared/fast_slam.json --serialize-every 10 \\
      --checkpoint runs/ck.npz --checkpoint-every 200
  python -m fastslam_tpu_torch run --log runs/log.fslog --plot runs/traj.png
  python -m fastslam_tpu_torch viz --path workspace/shared/fast_slam.json

``run`` without ``--chunk`` and ``sim`` drive the online per-tick loop
(``run_driver``), in parity mode unless ``--production`` is given (then
through the fused tick, on the card one CUDA graph replay per tick), with
the production hooks that ``--health``, ``--metrics``, ``--serialize`` and
``--checkpoint`` turn on (all off by default); ``run --chunk N`` is the
batch replay, always in production mode, and takes no hooks.  Both execute on
``--device cuda`` unless ``--device cpu`` is given, and stop with an error
when there is no GPU rather than fall back to the CPU.  ``run --plot PNG``
also writes the trajectory plot; ``viz`` watches the viewer's JSON snapshot
(both need matplotlib).
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


def _prepare_device(device: str) -> None:
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    # the frontend's float32 products must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _make_config(args):
    from fastslam_tpu_torch.config import FastSLAMConfig

    return FastSLAMConfig(
        num_particles=args.particles, max_landmarks=args.landmarks,
        parity_mode=not args.production, warmup_iterations=args.warmup,
    )


def _hooks(args) -> dict:
    """``run_driver``'s production hook arguments from the flags."""
    return dict(health=args.health, metrics_path=args.metrics,
                serialize_path=args.serialize, serialize_every=args.serialize_every,
                checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every)


def cmd_run(args) -> int:
    from fastslam_tpu_torch.app.runner import replay_chunked, run_driver
    from fastslam_tpu_torch.drivers.replay import LaserLog, ReplayDriver

    _prepare_device(args.device)
    log = LaserLog.load(args.log)
    if args.chunk:
        if args.health or args.metrics or args.serialize or args.checkpoint:
            raise SystemExit("the production hooks run in the online loop: drop --chunk")
        # the chunked engine runs the production math
        cfg = _make_config(args).replace(parity_mode=False)
        hist = replay_chunked(log, cfg, chunk_size=args.chunk, rng=args.seed,
                              device=args.device)
    else:
        hist = run_driver(ReplayDriver(log), _make_config(args), rng=args.seed,
                          device=args.device, **_hooks(args))
    metrics = hist.metrics(skip=args.skip_ticks)
    metrics["device"] = args.device
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        from fastslam_tpu_torch.viz.map_plot import plot_trajectory

        fig, _ = plot_trajectory(hist)
        fig.savefig(args.plot, dpi=120)
        metrics["plot"] = args.plot
    print(json.dumps(metrics))
    return 0


def cmd_viz(args) -> int:
    from fastslam_tpu_torch.viz.map_plot import watch

    watch(args.path, interval=args.interval)
    return 0


def cmd_sim(args) -> int:
    from fastslam_tpu_torch.app.runner import run_driver
    from fastslam_tpu_torch.drivers.sim_world import SimWorld

    _prepare_device(args.device)
    world = SimWorld(seed=args.seed, range_noise_std=args.range_noise)
    hist = run_driver(world, _make_config(args), max_ticks=args.ticks, rng=args.seed,
                      device=args.device, **_hooks(args))
    metrics = hist.metrics()
    metrics["device"] = args.device
    print(json.dumps(metrics))
    return 0


def _add_filter_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--particles", type=int, default=128)
    p.add_argument("--landmarks", type=int, default=32, help="per-particle capacity")
    p.add_argument("--production", action="store_true",
                   help="production math (log-weights, best-match association) "
                        "instead of the reference-parity quirks; the chunked "
                        "replay always uses it")
    p.add_argument("--warmup", type=int, default=150, help="dead-reckoning ticks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def _add_hook_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--health", action="store_true",
                   help="health check every tick, recovering from --checkpoint")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="JSONL metrics log (a tick record per tick)")
    p.add_argument("--serialize", default=None, metavar="PATH",
                   help="the viewer's JSON snapshot")
    p.add_argument("--serialize-every", type=int, default=1, metavar="N",
                   help="ticks between snapshots")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="checkpoint of the whole filter state")
    p.add_argument("--checkpoint-every", type=int, default=200, metavar="N",
                   help="ticks between checkpoints")


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
    p.add_argument("--plot", default=None, help="write the trajectory plot PNG")
    p.add_argument("--chunk", type=int, default=0,
                   help="batch replay: ticks per chunked kernel call "
                        "(production math; 0 = the per-tick online loop)")
    p.add_argument("--skip-ticks", type=int, default=0,
                   help="skip first N ticks in metrics")
    _add_filter_args(p)
    _add_hook_args(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sim", help="run SLAM live against the synthetic world")
    p.add_argument("--ticks", type=int, default=500)
    p.add_argument("--range-noise", type=float, default=0.0)
    _add_filter_args(p)
    _add_hook_args(p)
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("viz", help="watch the shared JSON snapshot (viewer)")
    p.add_argument("--path", default="workspace/shared/fast_slam.json")
    p.add_argument("--interval", type=float, default=0.5)
    p.set_defaults(fn=cmd_viz)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
