"""The ring resampler across processes, the counterpart of
``scripts/check_ring_resample.py``.

The JAX script can run its ring kernel only on a 1-shard ring of one chip (a
self-exchange).  This one starts ``--processes`` processes joined by gloo,
each holding ``--shards`` shards of the device, and builds the ring across
them, so that every exchange crosses a process boundary: on the card each
process launches the exchange kernel's cross-process form
(``core/cuda_kernels.py:ring_halo_exchange_peers``); with ``--device cpu``
the plain exchange runs over the group.  Each process resamples the state
of ``parallel/dryrun.py:resampler_state`` with ``ring_halo_resample`` on
healthy weights (the halo path) and on weights collapsed onto the last
three particles (the whole-state fallback), and compares the gathered
result with the single-device ``resample_state``.  Then it runs
``--exchanges`` consecutive exchanges, each on new blocks, against the plain
exchange (``ppermute`` over the group), and with ``--reps`` times both
exchanges and both distributed resamplers in turns::

    python -m fastslam_tpu_torch.probes.check_ring_resample [--processes 2] \\
        [--shards 1] [--particles 1024] [--landmarks 16] [--exchanges 20] \\
        [--reps 0] [--device cuda]

prints one JSON line: per weight profile the largest absolute difference of
each field over the processes and each process's launches of the
cross-process kernel, and each process's launch counters after both
resamples (``launches``, set to 0 before them); the exchanges' largest
difference, whether all were
equal bit for bit, and the launches; ``ok`` (every difference 0, and on the
card one launch per process per resample or exchange); the times of each
process (``--reps``); and ``device`` and ``power_limit_w``.  A process that
fails or outlives ``--timeout`` seconds fails the command.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

import torch

FIELDS = ("poses", "log_weights", "lm_mean", "lm_cov", "lm_count")
PROFILES = ("healthy", "collapsed")
U0 = 0.0042   # the JAX script's resample offset


def resample_checks(cfg, mesh, device) -> dict:
    """``ring_halo_resample`` of both profiles' states on ``mesh`` against
    the single-device ``resample_state``, every launch counter set to 0
    just before: per profile the largest absolute difference of each field
    and this process's launches of the cross-process kernel, and under
    ``"launches"`` every counter just after."""
    from fastslam_tpu_torch.core import cuda_kernels, kernels
    from fastslam_tpu_torch.parallel import dryrun
    from fastslam_tpu_torch.parallel.mesh import shard_state, unshard
    from fastslam_tpu_torch.parallel.ring_resample import ring_halo_resample

    for k in cuda_kernels.LAUNCHES:
        cuda_kernels.LAUNCHES[k] = 0
    out = {}
    for profile in PROFILES:
        state = dryrun.resampler_state(cfg, device, profile)
        u0 = torch.tensor(U0, device=device)
        want = kernels.resample_state(
            state, kernels.systematic_resample_indices(torch.exp(state.log_weights), u0), cfg)
        before = cuda_kernels.LAUNCHES["ring_halo_exchange_peers"]
        got = unshard(ring_halo_resample(shard_state(state, mesh, cfg), u0, mesh, cfg), mesh)
        out[profile] = {
            "max_abs_err": {k: float((getattr(got, k).double() - getattr(want, k).double())
                                     .abs().max()) for k in FIELDS},
            "peer_launches": cuda_kernels.LAUNCHES["ring_halo_exchange_peers"] - before}
    out["launches"] = dict(cuda_kernels.LAUNCHES)
    return out


def block_shape(cfg, mesh):
    """A packed particle block of one shard: ``[P_local, 3 + 1 + 6L + 1]``."""
    return cfg.num_particles // mesh.particle_shards, 3 + 1 + 6 * cfg.max_landmarks + 1


def check_exchanges(cfg, mesh, device, n: int, seed: int = 0) -> dict:
    """``n`` consecutive exchanges over the mesh's group, each on new random
    blocks, each against the plain exchange (``ppermute`` over the group):
    the largest absolute difference, whether every halo was equal bit for
    bit, and the cross-process kernel's launches."""
    from fastslam_tpu_torch.core import cuda_kernels

    gen = torch.Generator(device=device).manual_seed(seed + mesh.process_index)
    worst, equal = 0.0, True
    before = cuda_kernels.LAUNCHES["ring_halo_exchange_peers"]
    for _ in range(n):
        blocks = [torch.randn(block_shape(cfg, mesh), generator=gen, device=device)
                  for _ in mesh.devices]
        # the kernel's halos live in the ring's buffers until the next
        # exchange: compare them before that
        got = cuda_kernels.ring_halo_exchange_peers(blocks, mesh.group)
        want = cuda_kernels.ring_halo_exchange_peers_ref(blocks, mesh.group)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            worst = max(worst, float((g - w).abs().max()))
            equal = equal and torch.equal(g, w)
    return {"exchanges": n, "max_abs_err": worst, "equal": equal,
            "launches": cuda_kernels.LAUNCHES["ring_halo_exchange_peers"] - before}


def _ms_per_call(fn, reps: int, device) -> float:
    """Host ms per call of ``fn`` over ``reps`` calls after one warm-up,
    the device synchronised at both ends."""
    import time

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def times(cfg, mesh, device, reps: int) -> dict:
    """This process's ms per call, in turns (kernel, plain, plain, kernel):
    the exchange through the cross-process kernel and through the plain
    exchange; then ``ring_halo_resample`` and the halo resampler (its halos
    field by field through ``ppermute``) on the healthy state."""
    from fastslam_tpu_torch.core import cuda_kernels
    from fastslam_tpu_torch.parallel import dryrun
    from fastslam_tpu_torch.parallel.mesh import shard_state
    from fastslam_tpu_torch.parallel.resample import halo_systematic_resample
    from fastslam_tpu_torch.parallel.ring_resample import ring_halo_resample

    gen = torch.Generator(device=device).manual_seed(mesh.process_index)
    blocks = [torch.randn(block_shape(cfg, mesh), generator=gen, device=device)
              for _ in mesh.devices]
    group = mesh.group
    exchange = {"kernel": lambda: cuda_kernels.ring_halo_exchange_peers(blocks, group),
                "plain": lambda: cuda_kernels.ring_halo_exchange_peers_ref(blocks, group)}
    shards = shard_state(dryrun.resampler_state(cfg, device, "healthy"), mesh, cfg)
    u0 = torch.tensor(U0, device=device)
    resample = {"ring": lambda: ring_halo_resample(shards, u0, mesh, cfg),
                "halo": lambda: halo_systematic_resample(shards, u0, mesh, cfg)}
    out = {}
    for table, order in ((exchange, ("kernel", "plain", "plain", "kernel")),
                         (resample, ("ring", "halo", "halo", "ring"))):
        for name in order:
            out.setdefault(name, []).append(_ms_per_call(table[name], reps, device))
    return out


def worker(rank: int, port: int, outdir: str, args) -> None:
    """One process of the ring: the resample checks, the exchanges and (with
    ``--reps``) the times, written to ``outdir/worker_<rank>.json``."""
    import torch.distributed as dist

    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.core import cuda_kernels
    from fastslam_tpu_torch.parallel.mesh import make_mesh
    from fastslam_tpu_torch.parallel.multihost import initialize_distributed

    initialize_distributed(f"localhost:{port}", args.processes, rank)
    device = torch.device(args.device)
    cfg = FastSLAMConfig(num_particles=args.particles, max_landmarks=args.landmarks,
                         max_measurements=4)
    mesh = make_mesh(cfg, [device] * args.shards)
    out = {"resample": resample_checks(cfg, mesh, device),
           "exchange": check_exchanges(cfg, mesh, device, args.exchanges)}
    if args.reps:
        out["times"] = times(cfg, mesh, device, args.reps)
    cuda_kernels.close_peer_rings(mesh.group)
    with open(os.path.join(outdir, f"worker_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(processes: int = 2, shards: int = 1, particles: int = 1024, landmarks: int = 16,
        device: str = "cuda", exchanges: int = 20, reps: int = 0,
        timeout: float = 600.0) -> dict:
    """Start the processes, wait for them, and merge what they found."""
    from fastslam_tpu_torch.probes import device_fields

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA GPU")
    if particles % (processes * shards):
        raise ValueError(f"{particles} particles do not split over "
                         f"{processes} x {shards} shards")
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    flags = ["--processes", str(processes), "--shards", str(shards), "--particles",
             str(particles), "--landmarks", str(landmarks), "--device", device,
             "--exchanges", str(exchanges), "--reps", str(reps)]
    with tempfile.TemporaryDirectory() as outdir:
        procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, "--worker", str(rank),
                                   str(port), outdir, *flags],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for rank in range(processes)]
        try:
            for rank, proc in enumerate(procs):
                stdout, stderr = proc.communicate(timeout=timeout)
                if proc.returncode != 0:
                    raise RuntimeError(f"process {rank} exited {proc.returncode}:\n"
                                       f"{stdout[-2000:]}\n{stderr[-2000:]}")
        finally:
            for proc in procs:
                proc.kill()
                proc.wait(timeout=60)
        found = []
        for rank in range(processes):
            with open(os.path.join(outdir, f"worker_{rank}.json")) as f:
                found.append(json.load(f))
    on_card = torch.device(device).type == "cuda"
    resample = {p: {"max_abs_err": {k: max(w["resample"][p]["max_abs_err"][k] for w in found)
                                    for k in FIELDS},
                    "peer_launches": [w["resample"][p]["peer_launches"] for w in found]}
                for p in PROFILES}
    launches = [w["resample"]["launches"] for w in found]
    exchange = {"exchanges": exchanges,
                "max_abs_err": max(w["exchange"]["max_abs_err"] for w in found),
                "equal": all(w["exchange"]["equal"] for w in found),
                "launches": [w["exchange"]["launches"] for w in found]}
    ok = (all(v == 0.0 for r in resample.values() for v in r["max_abs_err"].values())
          and all(r["peer_launches"] == [int(on_card)] * processes for r in resample.values())
          and exchange["equal"] and exchange["launches"] == [exchanges * on_card] * processes)
    out = {"processes": processes, "shards_per_process": shards,
           "ring_shards": processes * shards, "particles": particles, "landmarks": landmarks,
           "resample": resample, "launches": launches, "exchange": exchange, "ok": ok,
           **device_fields(torch.device(device))}
    if reps:
        out["times"] = [w["times"] for w in found]
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--shards", type=int, default=1, help="shards in each process")
    ap.add_argument("--particles", type=int, default=1024)
    ap.add_argument("--landmarks", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--exchanges", type=int, default=20,
                    help="exchanges on new blocks, each against the plain exchange")
    ap.add_argument("--reps", type=int, default=0,
                    help="calls per timed turn (0: no times)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each process may take")
    ap.add_argument("--worker", nargs=3, metavar=("RANK", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.worker:
        rank, port, outdir = args.worker
        worker(int(rank), int(port), outdir, args)
        # torch's destructors at interpreter exit can abort a gloo process
        # after its work is done and written: leave without running them
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    out = run(args.processes, args.shards, args.particles, args.landmarks, args.device,
              args.exchanges, args.reps, args.timeout)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
