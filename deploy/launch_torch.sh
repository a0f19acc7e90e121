#!/usr/bin/env bash
# End-to-end launcher of the PyTorch/CUDA engine (fastslam_tpu_torch): install
# the package, record a synthetic laser log, run SLAM on it, print metrics.
# The counterpart of deploy/launch.sh: the same record -> run --production
# pipeline and the same settings, with DEVICE in place of CPU=1.  The engine
# runs on the card (its kernels build with nvcc at the first launch); with
# DEVICE=cpu it runs the kernels' plain versions on the CPU.
#
# Usage:
#   deploy/launch_torch.sh                          # install + smoke pipeline (512 ticks)
#   SKIP_INSTALL=1 deploy/launch_torch.sh           # pipeline only (already installed)
#   SKIP_INSTALL=1 DEVICE=cpu deploy/launch_torch.sh                  # no GPU
#   PARTICLES=100000 TICKS=2000 CHUNK=16 deploy/launch_torch.sh      # scale it up
#   CHECKPOINT=runs/ck.npz SERIALIZE=workspace/shared/fast_slam.json \
#     deploy/launch_torch.sh     # the online loop with its production hooks: health,
#                                # metrics ($OUT/metrics.jsonl), a checkpoint every
#                                # 200 ticks, a viewer snapshot every 10
set -euo pipefail
cd "$(dirname "$0")/.."

PARTICLES="${PARTICLES:-1024}"
TICKS="${TICKS:-512}"
CHUNK="${CHUNK:-0}"
OUT="${OUT:-runs/deploy_smoke_torch}"
DEVICE="${DEVICE:-cuda}"  # torch device; without a GPU pass DEVICE=cpu

if [ -z "${SKIP_INSTALL:-}" ]; then
  # the port needs torch and numpy only (installed beside CUDA); the
  # package's declared dependencies are the JAX engine's
  python -m pip install --quiet --no-deps --no-build-isolation .
fi

mkdir -p "$OUT"
python -m fastslam_tpu_torch record --ticks "$TICKS" --seed 3 \
    --out "$OUT/log.npz"

RUN_ARGS=(run --log "$OUT/log.npz" --particles "$PARTICLES" --production
          --device "$DEVICE")
if [ "$CHUNK" != "0" ]; then
  RUN_ARGS+=(--chunk "$CHUNK")
fi
# the production hooks run in the online loop (CHUNK=0)
if [ -n "${CHECKPOINT:-}" ]; then
  RUN_ARGS+=(--health --metrics "$OUT/metrics.jsonl" --checkpoint "$CHECKPOINT"
             --checkpoint-every 200)
fi
if [ -n "${SERIALIZE:-}" ]; then
  RUN_ARGS+=(--serialize "$SERIALIZE" --serialize-every 10)
fi
python -m fastslam_tpu_torch "${RUN_ARGS[@]}"
