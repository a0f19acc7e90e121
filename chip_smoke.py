"""Smoke test of the PyTorch/CUDA port (``fastslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each (or more):

0. environment: the card's name and power limit (exits non-zero without a GPU);
1. build the CUDA kernels from ``fastslam_tpu_torch/csrc`` with nvcc, and
   print each kernel instance's registers, spills and static shared memory
   from the ``ptxas`` report, the staged kernels' tile, lanes and dynamic
   shared memory at the bench geometry (fs2, and both motion kernels in
   both modes with their ptxas lines), and the fused ICP kernel's layout at
   180 x 180 points;
2. the per-tick motion kernel (a staged tile) against its plain PyTorch
   version at the bench geometry (P=100,000 particles, L=64 landmark slots,
   M=16 measurements), production and parity, from a state seeded by 3
   plain ticks, and at a ragged P=1,000 with L in {16, 64, 256}, tiles of
   mixed counts and maps filling to L within the tick, both modes: every
   output bit for bit;
3. the chunked motion kernel (a tile staged once per chunk) against its
   plain version, C=16 ticks, bit for bit: at the bench geometry in both
   modes, at a ragged P=1,000 with L in {16, 64, 256}, tiles of mixed
   counts and maps filling to L within the chunk, both modes, and in parity
   at L=512 (a tile of 16);
4. the motion main path: record a 300-tick synthetic log and replay it with
   ``replay_chunked`` on the GPU at P=100,000, L=64, chunk 16; the launch
   counters must show 18 chunked and 12 per-tick motion launches and no fs2
   launch, the ATE must be under 0.1 m, a second run must give the same
   estimates bit for bit, and a small noise-free replay must agree with the
   CPU path;
5. the per-tick FastSLAM 2.0 kernel against its plain version at the bench
   geometry, for both weightings (EKF pass, and evidence with the mode dial
   at 0.37): every output bit for bit;
6. the chunked fs2 kernel against its plain version, C=16, rotation and
   translation ticks, per-tick floors and the dial at 0.37 on some ticks,
   bit for bit;
7. the fs2 main path: the same replay with ``proposal_mode="fastslam2"``;
   the counters must show 18 chunked and 12 per-tick fs2 launches and no
   motion launch, the ATE must be under 0.15 m, and a second run must give
   the same estimates bit for bit;
8. fs2 on the card against the CPU: 3 chunks of 8 and 4 tail ticks at
   P=256, L=16 with the same draws; estimates and final state within
   atol = rtol = 1e-4;
9. kernel and plain times per tick, with CUDA events, and device times
   under ``torch.profiler``; both motion kernels at each launch geometry of
   ``MOTION_GEOMETRIES`` and the fs2 kernels at each of
   ``FS2_GEOMETRIES`` (tile, lanes), each bit for bit against the plain
   versions, then timed in turns; the ICP nearest-neighbour kernel's time
   per call on the adaptive replay's batch of cloud pairs beside its plain
   version and ``torch.cdist`` + masked ``min``; the fused point-to-line
   kernel per call on that batch (597 pairs) and on an online batch (2
   pairs), beside its plain version and the old per-iteration path (one
   search launch and ~45 eager ops per iteration), and at each geometry of
   ``ICP_GEOMETRIES`` (threads per pair, lanes per point), bit for bit;
10. the ICP kernels against their plain versions: the rotation's sinf/cosf
    against ``torch.sin``/``torch.cos`` on 10^8 values in [-4 pi, 4 pi] and
    the edges; the nearest-neighbour search on the adaptive replay's own
    batch (597 pairs of 180-point scans), random clouds with ties and
    invalid targets, one large pair through the shared-memory tiling and
    70,000 pairs; the fused point-to-line kernel on the replay batch,
    2-pair online batches, random clouds with ties and invalid targets, an
    all-invalid target, pairs that run to ``max_iter``, and a 4096 x 8192
    pair (targets in tiles, per-point arrays in scratch); all outputs equal;
11. the fs2 + ICP + adaptive-floors main path: ``replay_chunked`` at
    P=100,000, L=64, chunk 8 on the 300-tick drive, clean and with wheel
    slip (0.02, 0.02); the counters must show 37 chunked and 4 per-tick fs2
    launches, one fused ICP launch (the ICP stage), no search launch and no
    motion launch; ATE under 0.05 m clean and 0.10 m with slip; a second
    clean run must repeat bit for bit; and at P=256, L=16 the ICP stage
    (blended odometry, floors, dial) and a noise-free motion + ICP replay
    must agree with the CPU path;
12. the online main path: ``run_driver(ReplayDriver(log))`` at P=100,000,
    L=64, fs2 + ICP + adaptive floors, 300 ticks, twice.  First the split
    path (``fuse_online_tick=False``): 300 per-tick fs2 launches, no
    chunked one, one fused ICP launch per tick with a previous scan (299)
    and no search launch, ATE under 0.05 m, a second run bit for bit, and
    the wall time per tick with its host-clock split (ICP refinement,
    frontend + step) as ``run_driver`` records it.  Then the production
    path, the fused tick: the first tick eager, then one replay of the
    captured CUDA graph per tick (299), 300 fs2 and 300 fused ICP launches
    (replays counted), ATE under 0.05 m, a second run bit for bit, and the
    same 300 estimates as the fused tick run eagerly on the card (no
    graph); ms per tick of each, with the card's name and power limit; the
    graph's device time per replay and its top kernels, and the cost of the
    resample decided on the device and of the copy back into the static
    state;
13. the ring halo exchange kernel against its plain version: S in {1, 2, 4,
    8} shards of P=100,000 particles at L=64 (blocks of 389 floats per
    particle) and a ragged case (12,501 particles per shard at S=8); equal
    exactly;
14. the distributed resamplers at S=4, P=100,000, L=64: the ring resampler
    (through the exchange kernel, one launch per call) and the halo
    resampler against ``resample_state`` on the gathered state, healthy
    weights and weights collapsed onto the last shard (the fallback); every
    field bit for bit;
15. the sharded main path: the dry run of ``parallel/dryrun.py`` on 4 shards
    of the card at P=100,000, L=64, M=16, C=16 (the blocks step: motion
    parity, motion production with the halo resampler, fs2; the planes step:
    motion, fs2; the chunked step: motion, fs2, fs2 with the adaptive floors
    0.002 and the dial [1, .5, 0, ...]; 3 ticks or 1 chunk each, and the
    forced resamples); 4 launches per tick or chunk of the kernel each step
    names; each step bit for bit the same at S=1 and on the single-device
    step;
16. the exchange kernel's time (CUDA events) beside its plain version, two
    ``torch.roll`` calls of the stacked blocks and its bound, and the
    sharded chunked steps' ms per tick at S=4 beside S=1;
17. the ceiling probes at L=64, P=100,000 (tile 256, 256 passes): the copy,
    ``mul_add`` and ``fma_chain`` kernels against their plain versions (the
    first two exactly, ``fma_chain`` within rtol 1e-6); the probes' main
    path, ``probes.hbm_floor.run`` and ``probes.vpu_roofline.run``, with
    their launches; the copy's library call (``torch._foreach_add``); the
    achieved GB/s, shared-memory bytes/s and FMA TFLOP/s beside their bounds
    and the SM clock sampled in the phase; and a short run of both probe
    commands as subprocesses, whose JSON lines must parse;
18. the fused online loop of phase 12 again with every hook on (a snapshot
    every 10 ticks, a metrics JSONL, a checkpoint at tick 150, health): the
    same 300 estimates bit for bit, a parseable snapshot of at most 500 particles
    and at least one landmark, 300 tick records, the checkpoint back at
    iteration 150 with full shapes and finite arrays, no
    ``nan_or_inf_state``; ms per tick with and without hooks and the
    seconds each hook took;
19. the reference API: ``api.FastSLAM2`` at P=100,000, L=64, production, 10
    ticks of ``bench.py``'s measurement set (finite poses, 10 launches of the
    per-tick update kernel), and ``api.ICP`` on a pair of the drive equal to
    ``proposal/icp.icp`` on the same pair;
20. corner tracking and the JdeRobot traces on the fused online loop:
    ``track_corners=True`` with fs2 + ICP + adaptive floors at P=100,000,
    L=64, 300 ticks through the captured graph (ATE under 0.05 m, 299
    replays, the same launches as phase 12's fused run), equal bit for bit
    to its eager run on the card; then both committed traces
    (``data/jderobot/*.jsonl`` through ``load_hal_trace`` and
    ``ReplayDriver``) on the fused loop at P=100,000, each ATE under 0.06 m,
    with ms per tick.

Any failure raises.  The line before the last is a JSON summary of the
kernels (launches of each main path's first run and their sum; the bound
from this run's shapes and the landmark slots the timed calls read and
write, against the H100's published peaks); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

P, L, M, C = 100_000, 64, 16, 16
# bench.py's measurement set: (range, bearing) pairs
MEASUREMENTS = [(2.0 + 0.3 * i, -2.5 + 0.35 * i) for i in range(16)]
TOL = 1e-4   # atol and rtol, the card against the CPU (phase 8)
DEVICE = "cuda"
KERNELS = {   # name: (source, the TPU kernel it replaces)
    "fused_update_planes": ("fastslam_tpu_torch/csrc/fused_update.cu",
                            "fastslam_tpu/core/pallas_kernels.py:618"),
    "fused_update_planes_multi": ("fastslam_tpu_torch/csrc/fused_update.cu",
                                  "fastslam_tpu/core/pallas_kernels.py:1403"),
    "fused_fs2_planes": ("fastslam_tpu_torch/csrc/fused_fs2.cu",
                         "fastslam_tpu/core/pallas_kernels.py:1113"),
    "fused_fs2_planes_multi": ("fastslam_tpu_torch/csrc/fused_fs2.cu",
                               "fastslam_tpu/core/pallas_kernels.py:1735"),
    "icp_correspondences": ("fastslam_tpu_torch/csrc/icp_nn.cu",
                            "fastslam_tpu/core/pallas_kernels.py:1901"),
    # the search of pallas_kernels.py:1901 with the while-loop of
    # fastslam_tpu/proposal/icp.py:178 around it
    "icp_point_to_line": ("fastslam_tpu_torch/csrc/icp_nn.cu",
                          "fastslam_tpu/core/pallas_kernels.py:1901"),
    "ring_halo_exchange": ("fastslam_tpu_torch/csrc/ring_halo.cu",
                           "fastslam_tpu/parallel/ring_resample.py:106"),
    "hbm_copy": ("fastslam_tpu_torch/csrc/probes.cu", "scripts/bench_hbm_floor.py:47"),
    "mul_add": ("fastslam_tpu_torch/csrc/probes.cu", "scripts/bench_vpu_roofline.py:112"),
    "fma_chain": ("fastslam_tpu_torch/csrc/probes.cu", "scripts/bench_vpu_roofline.py:115"),
}
MOTION = ("fused_update_planes", "fused_update_planes_multi")
FS2 = ("fused_fs2_planes", "fused_fs2_planes_multi")
ICP = "icp_correspondences"
FUSED_ICP = "icp_point_to_line"
RING = "ring_halo_exchange"
PROBES = ("hbm_copy", "mul_add", "fma_chain")
PROBE_TILE, PROBE_PASSES = 256, 256
# the fs2 kernels' launch geometries timed in phase 9: (particles per tile,
# lanes per particle)
FS2_GEOMETRIES = ((128, 1), (64, 1), (64, 2), (64, 4), (32, 2), (32, 4), (32, 8))
# the motion kernels' launch geometries timed in phase 9 (both kernels take
# motion_launch_geometry's one geometry)
MOTION_GEOMETRIES = ((16, 8), (32, 2), (32, 4), (32, 8), (64, 2), (64, 4), (16, 16))
# the fused ICP kernel's: (threads per cloud pair, lanes per source point)
ICP_GEOMETRIES = ((128, 4), (256, 4), (256, 8), (512, 8), (512, 16), (1024, 16), (1024, 32))
ONLINE_TICK = 150    # the online batch of phases 9-10: this tick's two matches
# the launches of the ICP main paths: the replay's ICP stage is one fused
# call; the online loop makes one per tick with a previous scan
ADAPTIVE_LAUNCHES = {"fused_fs2_planes_multi": 37, "fused_fs2_planes": 4, "icp_point_to_line": 1}
ONLINE_LAUNCHES = {"fused_fs2_planes": 300, "icp_point_to_line": 299}
# the fused tick: one 2-pair ICP launch in every tick (the first tick's is
# masked by has_prev), replays counted
ONLINE_FUSED_LAUNCHES = {"fused_fs2_planes": 300, "icp_point_to_line": 300}
TRACE_ATE = 0.06     # the JdeRobot traces on the fused loop (EVAL.md:72, ~2x)
SIN_COS_VALUES = 100_000_000
FMA_RTOL = 1e-6      # fma_chain vs its plain version: rare double roundings
# shared memory streams 32 banks x 4 bytes per clock on each SM
SMEM_BYTES_PER_CLOCK_PER_SM = 128
SHARDS = 4           # shards of the sharded main path, all on the one card
ADAPTIVE_C = 8       # the chunk of the adaptive replay (EVAL.md:55 geometry)
SLIP = (0.02, 0.02)  # wheel slip (rotation, translation std-devs)

# the H100 SXM's published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# operations of the filter kernels, counted from the plain versions'
# arithmetic: per usable landmark slot of one association pass, and per
# measurement and particle outside that loop (observation, EKF, weight;
# the fs2 proposal accumulation), and per particle for the fs2 solve+sample
ASSOC_OPS_PER_SLOT = 20
EKF_OPS = 120
PROPOSAL_OPS = 100
SAMPLE_OPS = 80
# per (source point, valid target) of the ICP search: 2 sub, 2 mul, add, compare
NN_OPS = 6
# per source point and iteration of the fused ICP outside the search: sqrt,
# r and J (9), w and its products (13), the tree's 11 adds, the move (8)
ICP_POINT_OPS = 42
PLANES = ("lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cd")   # production's five


def phase(n, text):
    print(f"[phase {n}] {text}", flush=True)


def config(**kw):
    from fastslam_tpu_torch.config import FastSLAMConfig

    kw.setdefault("parity_mode", False)
    return FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M, **kw)


def compare(name, got, want, tol=TOL):
    """Max abs error of ``got`` vs ``want``; raises past atol=rtol=tol."""
    import torch

    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {int(bad.sum())} values off, max abs err "
                             f"{err.max().item():.3e}")
    return err.max().item()


def ptxas_summary(report: str):
    """``kernel<flags>: N registers, S B spill stores, S' B spill loads, B B
    static shared memory`` per kernel instance."""
    out, name = [], None
    for line in report.splitlines():
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            m = re.search(r"(fused_(?:update|fs2)_planes(?:_multi)?_kernel)I((?:Lb[01]E)+)",
                          entry.group(1))
            plain = next((k for k in ("icp_nn_kernel", "icp_point_to_line_kernel",
                                      "icp_sin_cos_kernel", "ring_halo_kernel",
                                      "hbm_copy_kernel", "mul_add_kernel",
                                      "fma_chain_kernel")
                          if k in entry.group(1)), entry.group(1))
            name = (f"{m.group(1)}<{','.join(re.findall('Lb([01])E', m.group(2)))}>"
                    if m else plain)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            out.append([name, None, int(spill.group(1)), int(spill.group(2)), 0])
        regs = re.search(r"Used (\d+) registers", line)
        if regs and out and out[-1][0] == name:
            out[-1][1] = int(regs.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1][4] = int(smem.group(1)) if smem else 0
    return [f"{n}: {r} registers, {s} B spill stores, {sl} B spill loads, {sm} B static "
            f"shared memory" for n, r, s, sl, sm in out]


def seeded_state(cfg, gen, ms):
    """A state after 3 plain ticks of translation: maps with matched and
    freshly appended landmarks, non-uniform weights."""
    from fastslam_tpu_torch.core import cuda_kernels, kernels
    from fastslam_tpu_torch.core.state import init_planes_state

    state = init_planes_state(cfg, DEVICE)
    for _ in range(3):
        d = kernels.draw(gen, cfg.num_particles)
        poses = kernels.propagate_particles(
            state.poses, 0.0, 0.4, cfg.rotation_noise * d.rot,
            cfg.translation_noise * d.trans)
        cuda_kernels.fused_update_planes_ref(
            poses, state.log_weights, state.lm_mx, state.lm_my, state.lm_ca,
            state.lm_cb, state.lm_cc, state.lm_cd, state.lm_count,
            ms.range_bearing, ms.valid, cfg)
        state = state.replace(
            poses=poses,
            log_weights=kernels.normalize_log_weights(state.log_weights, cfg))
    return state


def args_of(state):
    return (state.log_weights, state.lm_mx, state.lm_my, state.lm_ca,
            state.lm_cb, state.lm_cc, state.lm_cd, state.lm_count)


def compare_exact(tag, got, want):
    """Every output of a kernel bit for bit against its plain version's
    (``None`` on both sides where production has no cc plane); returns the
    max abs error, 0.0."""
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        if w is None and g is None:
            continue
        if g is None or w is None or g.dtype != w.dtype or not torch.equal(g, w):
            off = "a missing output" if g is None or w is None else \
                f"{int((g != w).sum())} of {w.numel()} values"
            raise AssertionError(f"{tag}: output {i} differs from the plain version in {off}")
    return 0.0


def chunk_motion():
    """Per-tick rotation and translation of a chunk: every fourth tick
    rotates by 0.2 rad, the others translate 0.4 m."""
    import torch

    rotating = torch.arange(C, device=DEVICE) % 4 == 3
    return rotating, torch.where(rotating, 0.2, 0.0), torch.where(rotating, 0.0, 0.4)


def tiled(ms):
    return (ms.range_bearing[None].expand(C, M, 2).contiguous(),
            ms.valid[None].expand(C, M).contiguous())


def phase2(gen, ms):
    import torch

    from fastslam_tpu_torch.core import cuda_kernels, kernels

    worst = 0.0
    for parity in (False, True):
        cfg = config(parity_mode=parity)
        state = seeded_state(cfg, gen, ms)
        d = kernels.draw(gen, P)
        poses = kernels.propagate_particles(
            state.poses, 0.0, 0.4, cfg.rotation_noise * d.rot,
            cfg.translation_noise * d.trans)
        sk, sp = state.clone(), state.clone()
        before = state.lm_count.clone()
        got = cuda_kernels.fused_update_planes(poses, *args_of(sk), ms.range_bearing,
                                               ms.valid, cfg)
        torch.cuda.synchronize()
        want = cuda_kernels.fused_update_planes_ref(poses, *args_of(sp),
                                                    ms.range_bearing, ms.valid, cfg)
        err = compare_exact("per-tick", got, want)
        worst = max(worst, err)
        updated = int((want[0] != state.log_weights).sum())
        appends = int((want[-1] > before).sum())
        phase(2, f"per-tick {'parity' if parity else 'production'}: every output "
                 f"(weights, planes, lm_count) equal to the plain version bit for bit, "
                 f"particles updated {updated}, appended {appends}")
    for l in (16, 64, 256):
        for parity in (False, True):
            cfg, state, poses, z, zv = ragged_motion_inputs(l, parity, seed=l + parity)
            tile = cuda_kernels.motion_launch_geometry(l, RAGGED_M, parity)[0]
            first = state.lm_count[:tile]
            if not int(first.min()) < int(first.max()):
                raise AssertionError("ragged motion state: the first tile's counts are not mixed")
            sk, sp = state.clone(), state.clone()
            got = cuda_kernels.fused_update_planes(poses, *args_of(sk), z, zv, cfg)
            torch.cuda.synchronize()
            want = cuda_kernels.fused_update_planes_ref(poses, *args_of(sp), z, zv, cfg)
            compare_exact(f"per-tick L={l} parity={parity}", got, want)
            before, after = state.lm_count, want[-1]
            filled = int(((before < l) & (after == l)).sum())
            # at 256 the scattered landmarks match what would append
            if (l < 256 and not filled) or not bool((after > before).any()):
                raise AssertionError(f"ragged motion L={l}: no map filled to L ({filled})")
            phase(2, f"per-tick {'parity' if parity else 'production'} L={l} P={RAGGED_P} "
                     f"(tiles of {tile}, the last ragged, counts mixed): every output equal "
                     f"to the plain version bit for bit, {filled} maps filled to L in the tick")
    return worst


RAGGED_P, RAGGED_M = 1000, 16
RAGGED_Z = [(1.0 + 0.35 * k, -2.8 + 0.37 * k) for k in range(RAGGED_M)]


def ragged_motion_inputs(l, parity, seed):
    """A planes state of RAGGED_P particles whose tiles mix every count from
    0 to L (a fifth two slots short of a full map, some full), slots 0..7
    near the first measurements' world points (matches), the rest scattered
    (appends); asymmetric covariances in parity mode; the tick's poses."""
    import numpy as np
    import torch

    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.core.state import init_planes_state

    rng = np.random.default_rng(seed)
    p = RAGGED_P
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=l, max_measurements=RAGGED_M,
                         parity_mode=parity)
    counts = rng.integers(0, l + 1, p)
    counts[::5] = max(l - 2, 0)
    counts[::13] = l
    means = rng.uniform(-9.0, 9.0, (2, l, p))
    for k in range(min(l, 8)):
        r, b = RAGGED_Z[2 * k]
        means[:, k] = np.array([r * np.cos(b), r * np.sin(b)])[:, None] \
            + rng.normal(0.0, 0.03, (2, p))
    a, d = rng.uniform(0.02, 0.2, (2, l, p))
    b = rng.uniform(-0.01, 0.01, (l, p))
    c = rng.uniform(-0.01, 0.01, (l, p)) if parity else None
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(DEVICE)
    state = init_planes_state(cfg, DEVICE).replace(
        log_weights=f32(np.log(rng.dirichlet(np.ones(p)))),
        lm_mx=f32(means[0]), lm_my=f32(means[1]), lm_ca=f32(a), lm_cb=f32(b),
        lm_cc=f32(c) if parity else None, lm_cd=f32(d),
        lm_count=torch.from_numpy(counts.astype(np.int32)).to(DEVICE))
    poses = f32(rng.normal(0.0, 0.05, (p, 3)))
    z = torch.tensor(RAGGED_Z, dtype=torch.float32, device=DEVICE)
    zv = torch.ones(RAGGED_M, dtype=torch.bool, device=DEVICE)
    zv[3] = False                                      # an interior hole
    return cfg, state, poses, z, zv


def ragged_motion_chunk(l, parity, seed, gen):
    """The ragged state of :func:`ragged_motion_inputs` and a chunk of C
    ticks of its measurements under :func:`chunk_motion`'s motion with
    noise: the same measurements land elsewhere on each tick, so slots
    appended on one tick are scanned on the next and maps fill to L."""
    import torch

    from fastslam_tpu_torch.core import kernels

    cfg, state, _, z, zv = ragged_motion_inputs(l, parity, seed)
    d = kernels.draw(gen, RAGGED_P, C)
    rotating, rots, trans = chunk_motion()
    noisy_rot = torch.where(rotating[:, None], rots[:, None] + 0.01 * d.rot, 0.0)
    noisy_trans = torch.where(rotating[:, None], 0.0, trans[:, None] + 0.05 * d.trans)
    return (cfg, state, z[None].expand(C, -1, -1).contiguous(),
            zv[None].expand(C, -1).contiguous(), noisy_rot, noisy_trans)


def run_chunk(fn, cfg, state, z, zv, noisy_rot, noisy_trans):
    """One call of a chunked motion function on a copy of ``state``."""
    s = state.clone()
    return fn(s.poses, s.log_weights, *args_of(s)[1:], z, zv, noisy_rot, noisy_trans, cfg)


def phase3(gen, ms):
    import torch

    from fastslam_tpu_torch.core import cuda_kernels, kernels

    worst = 0.0
    for parity in (False, True):
        cfg = config(parity_mode=parity)
        state = seeded_state(cfg, gen, ms)
        d = kernels.draw(gen, P, C)
        rotating, rots, trans = chunk_motion()
        noisy_rot = torch.where(rotating[:, None], rots[:, None] + cfg.rotation_noise * d.rot,
                                0.0)
        noisy_trans = torch.where(rotating[:, None], 0.0,
                                  trans[:, None] + cfg.translation_noise * d.trans)
        z, zv = tiled(ms)
        args = (cfg, state, z, zv, noisy_rot, noisy_trans)
        got = run_chunk(cuda_kernels.fused_update_planes_multi, *args)
        torch.cuda.synchronize()
        want = run_chunk(cuda_kernels.fused_update_planes_multi_ref, *args)
        worst = max(worst, compare_exact(f"chunked parity={parity}", got, want))
        appends = int((want[-1] > state.lm_count).sum())
        phase(3, f"chunked C={C} {'parity' if parity else 'production'}: every output "
                 f"(trajectories, planes, lm_count) equal to the plain version bit for bit, "
                 f"appended {appends}")
    for l, parity in [(l, parity) for l in (16, 64, 256) for parity in (False, True)] \
            + [(512, True)]:
        args = ragged_motion_chunk(l, parity, 30 + l + parity, gen)
        state = args[1]
        tile = cuda_kernels.motion_launch_geometry(l, RAGGED_M, parity)[0]
        first = state.lm_count[:tile]
        if not int(first.min()) < int(first.max()):
            raise AssertionError("ragged motion chunk: the first tile's counts are not mixed")
        got = run_chunk(cuda_kernels.fused_update_planes_multi, *args)
        torch.cuda.synchronize()
        want = run_chunk(cuda_kernels.fused_update_planes_multi_ref, *args)
        compare_exact(f"chunked L={l} parity={parity}", got, want)
        before, after = state.lm_count, want[-1]
        filled = int(((before < l) & (after == l)).sum())
        if (l <= 256 and not filled) or not bool((after > before).any()):
            raise AssertionError(f"ragged motion chunk L={l}: no map filled to L ({filled})")
        phase(3, f"chunked C={C} {'parity' if parity else 'production'} L={l} P={RAGGED_P} "
                 f"(tiles of {tile}, the last ragged, counts mixed): every output equal to "
                 f"the plain version bit for bit, {filled} maps filled to L in the chunk")
    return worst


def replay_main_path(n, log, cfg, kernels_run, ate_bar):
    """``replay_chunked`` twice with the counters zeroed just before the
    first run; the first run must launch only ``kernels_run`` (18 chunked,
    12 per-tick), reach ATE < ``ate_bar``, and the second must repeat its
    estimates bit for bit.  Returns (launches, ATE)."""
    import numpy as np
    import torch

    from fastslam_tpu_torch.app.runner import replay_chunked
    from fastslam_tpu_torch.core import cuda_kernels

    for k in cuda_kernels.LAUNCHES:
        cuda_kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    hist = replay_chunked(log, cfg, chunk_size=C, rng=0, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    tick, chunked = kernels_run
    expected = {k: 0 for k in launches} | {chunked: 18, tick: 12}
    if launches != expected:
        raise AssertionError(f"main path launches {launches}, expected {expected}")
    est = np.asarray(hist.est_poses)
    if est.shape != (300, 3) or not np.isfinite(est).all():
        raise AssertionError(f"estimates: shape {est.shape}, finite "
                             f"{np.isfinite(est).all()}")
    ate = hist.metrics()["ate_rmse_m"]
    if not ate < ate_bar:
        raise AssertionError(f"ATE {ate} m >= {ate_bar} m")
    phase(n, f"replay_chunked 300 ticks P={P} L={L} chunk {C} on cuda, "
             f"proposal {cfg.proposal_mode}: ATE {ate:.4f} m, wall {wall:.2f} s, "
             f"launches {launches}")
    again = np.asarray(replay_chunked(log, cfg, chunk_size=C, rng=0,
                                      device=DEVICE).est_poses)
    if not np.array_equal(again, est):
        raise AssertionError(f"a second run differs: max diff "
                             f"{np.abs(again - est).max():.3e}")
    phase(n, "a second run gives the same 300 estimates bit for bit")
    return launches, ate


def phase4(log):
    import numpy as np

    from fastslam_tpu_torch.app.runner import replay_chunked
    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld

    launches, _ = replay_main_path(4, log, config(), MOTION, 0.1)

    # the same path, noise-free and small, on the card and on the CPU
    small = FastSLAMConfig(num_particles=256, max_landmarks=16, parity_mode=False,
                           rotation_noise=0.0, translation_noise=0.0,
                           warmup_iterations=8)
    short = record_log(SimWorld(seed=3), num_ticks=52)
    on_gpu = np.asarray(replay_chunked(short, small, chunk_size=8, device=DEVICE).est_poses)
    on_cpu = np.asarray(replay_chunked(short, small, chunk_size=8, device="cpu").est_poses)
    diff = float(np.abs(on_gpu - on_cpu).max())
    if not diff < 1e-4:
        raise AssertionError(f"small replay: cuda vs cpu max diff {diff}")
    phase(4, f"small noise-free replay (P=256, 52 ticks): cuda vs cpu max diff {diff:.3e}")
    return launches


def fs2_tick_inputs(cfg, gen, state, dial):
    """Mean-motion prediction of a 0.4 m translation, draws and prior."""
    import torch

    from fastslam_tpu_torch.core import kernels

    zero = torch.zeros(P, device=DEVICE)
    pred = kernels.propagate_particles(state.poses, 0.0, 0.4, zero, zero)
    _, _, s_t2, s_r2, fxy = kernels.fs2_prior_scalars(
        torch.tensor(0.0, device=DEVICE), torch.tensor(0.4, device=DEVICE), cfg)
    noise = kernels.draw(gen, P, fs2=True).noise
    return pred, noise, s_t2, s_r2, fxy, dial


def phase5(gen, ms):
    import torch

    from fastslam_tpu_torch.core import cuda_kernels

    worst = 0.0
    for evidence, dial in ((False, None), (True, 0.37)):
        cfg = config(proposal_mode="fastslam2", fs2_evidence_weights=evidence)
        state = seeded_state(cfg, gen, ms)
        pred, noise, s_t2, s_r2, fxy, dial = fs2_tick_inputs(cfg, gen, state, dial)
        sk, sp = state.clone(), state.clone()
        before = state.lm_count.clone()
        tail = (ms.range_bearing, ms.valid, noise, s_t2, s_r2, fxy, cfg)
        got = cuda_kernels.fused_fs2_planes(pred, *args_of(sk), *tail,
                                            evidence_scale=dial)
        torch.cuda.synchronize()
        want = cuda_kernels.fused_fs2_planes_ref(pred, *args_of(sp), *tail,
                                                 evidence_scale=dial)
        err = compare_exact("fs2 per-tick", got, want)
        worst = max(worst, err)
        appends = int((want[-1] > before).sum())
        moved = float((want[0] - pred).abs().max())
        phase(5, f"fs2 per-tick, evidence weights {evidence}, dial {dial}: every output "
                 f"(poses, weights, planes, lm_count) equal to the plain version bit for "
                 f"bit, appended {appends}, max |sample - prediction| {moved:.3e}")
    return worst


def fs2_chunk_inputs(cfg, gen):
    """Chunk draws, the prior of rotation and translation ticks with
    per-tick floors, and the mode dial at 0.37 on every third tick."""
    import torch

    from fastslam_tpu_torch.core import kernels

    _, rots, trans = chunk_motion()
    floors = (torch.linspace(0.004, 0.02, C, device=DEVICE),
              torch.linspace(0.01, 0.002, C, device=DEVICE))
    dial = torch.where(torch.arange(C, device=DEVICE) % 3 == 1, 0.37, 1.0)
    prior = kernels.fs2_prior_scalars(rots, trans, cfg, floors)
    return kernels.draw(gen, P, C, fs2=True).noise, prior, dial


def phase6(gen, ms):
    import torch

    from fastslam_tpu_torch.core import cuda_kernels

    worst = 0.0
    for evidence in (False, True):
        cfg = config(proposal_mode="fastslam2", fs2_evidence_weights=evidence)
        state = seeded_state(cfg, gen, ms)
        noise, prior, dial = fs2_chunk_inputs(cfg, gen)
        z, zv = tiled(ms)
        sk, sp = state.clone(), state.clone()
        before = state.lm_count.clone()
        got = cuda_kernels.fused_fs2_planes_multi(
            state.poses, state.log_weights, *args_of(sk)[1:], z, zv, noise, *prior,
            cfg, evidence_scale=dial)
        torch.cuda.synchronize()
        want = cuda_kernels.fused_fs2_planes_multi_ref(
            state.poses, state.log_weights, *args_of(sp)[1:], z, zv, noise, *prior,
            cfg, evidence_scale=dial)
        err = compare_exact("fs2 chunked", got, want)
        worst = max(worst, err)
        appends = int((want[-1] > before).sum())
        full = int((want[-1] == L).sum())
        phase(6, f"fs2 chunked C={C}, evidence weights {evidence}: every output "
                 f"(trajectories, planes, lm_count) equal to the plain version bit for "
                 f"bit, appended {appends}, {full} maps full at the end")
    return worst


def phase8():
    """fs2 steps on the card against the CPU, from the same draws."""
    import numpy as np
    import torch

    from fastslam_tpu_torch.app.runner import odometry, scan_points
    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.core import kernels
    from fastslam_tpu_torch.core.state import Measurements, init_planes_state
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld
    from fastslam_tpu_torch.frontend.pipeline import scan_to_measurements
    from fastslam_tpu_torch.interop import planes_state_to_numpy

    p, c, chunks, tail = 256, 8, 3, 4
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=16, parity_mode=False,
                         proposal_mode="fastslam2")
    log = record_log(SimWorld(seed=3), num_ticks=c * chunks + tail)
    pts, valid = scan_points(log)
    ms = [scan_to_measurements(torch.from_numpy(a), torch.from_numpy(v), cfg)
          for a, v in zip(pts, valid)]
    rb = torch.stack([m.range_bearing for m in ms])
    mv = torch.stack([m.valid for m in ms])
    rots, trans = (torch.from_numpy(a) for a in odometry(log, cfg))
    gen = torch.Generator().manual_seed(8)
    draws = [kernels.draw(gen, p, c, fs2=True) for _ in range(chunks)]
    draws += [kernels.draw(gen, p, fs2=True) for _ in range(tail)]

    def run(device):
        to = lambda t: t.to(device)
        state = init_planes_state(cfg, device)
        est = []
        for i, d in enumerate(draws):
            d = kernels.Draws(None, None, to(d.u0), to(d.noise))
            if i < chunks:
                sl = slice(i * c, (i + 1) * c)
                state, e = kernels.fastslam_steps_planes_chunked(
                    state, to(rots[sl]), to(trans[sl]), Measurements(to(rb[sl]), to(mv[sl])),
                    cfg, d)
            else:
                t = c * chunks + i - chunks
                state, e = kernels.fastslam_step_planes(
                    state, to(rots[t]), to(trans[t]), Measurements(to(rb[t]), to(mv[t])),
                    cfg, d)
                e = e[None]
            est.append(e.cpu())
        return torch.cat(est).numpy(), planes_state_to_numpy(state)

    est_gpu, st_gpu = run(DEVICE)
    est_cpu, st_cpu = run("cpu")
    if not np.array_equal(st_gpu["lm_count"], st_cpu["lm_count"]):
        raise AssertionError("fs2 cuda vs cpu: lm_count differs")
    pairs = [("estimates", est_gpu, est_cpu)] + [
        (k, st_gpu[k], v) for k, v in st_cpu.items() if v is not None and k != "lm_count"]
    errs = {k: compare(f"fs2 cuda vs cpu {k}", torch.from_numpy(g), torch.from_numpy(c))
            for k, g, c in pairs}
    worst = max(errs, key=errs.get)
    phase(8, f"fs2 steps ({chunks} chunks of {c} + {tail} ticks, P={p}): cuda vs cpu "
             f"within atol=rtol={TOL}, max abs err {errs[worst]:.3e} ({worst}), "
             f"estimates {errs['estimates']:.3e}, "
             f"{int(st_cpu['lm_count'].max())} landmarks at most")


def time_ms(fn, reps):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes, ops):
    """The least time of a function on the H100: its bytes over the memory
    rate or its operations over the f32 rate, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def footprint(run, state):
    """(occupied slots, written slots) of one call of ``run`` on a copy of
    ``state``, each summed over particles: the kernels read the planes of
    the occupied slots only, and write only the slots that a measurement
    updates or appends (over a whole chunk for the chunked kernels)."""
    import torch

    copy = state.clone()
    run(copy)
    torch.cuda.synchronize()
    written = torch.zeros((L, P), dtype=torch.bool, device=DEVICE)
    for name in PLANES:
        written |= getattr(copy, name) != getattr(state, name)
    return int(state.lm_count.sum()), int(written.sum())


def filter_bounds(fp):
    """Bounds per tick of the four filter kernels at P, L, M, C.  ``fp``
    holds each kernel's :func:`footprint` on the state its timing starts
    from.  Each input is read once and each output written once: the five
    production planes over the occupied slots in and the written slots
    out, and the per-tick rows.  The association is counted over the
    occupied slots, a lower bound on its work (the chunked kernels' maps
    grow within a chunk)."""
    rows = (3 + 2 + 2 + 2) * P * 4          # poses, cos/sin yaw, logw and cnt r/w
    planes = {k: 5 * 4 * (slots + written) for k, (slots, written) in fp.items()}
    motion_ops = lambda k: M * (ASSOC_OPS_PER_SLOT * fp[k][0] + EKF_OPS * P)
    fs2_ops = lambda k: (M * (2 * ASSOC_OPS_PER_SLOT * fp[k][0]
                              + (PROPOSAL_OPS + EKF_OPS) * P) + SAMPLE_OPS * P)
    tick, chunk = "fused_update_planes", "fused_update_planes_multi"
    fs2_tick, fs2_chunk = "fused_fs2_planes", "fused_fs2_planes_multi"
    return {
        tick: bound_ms(planes[tick] + rows, motion_ops(tick)),
        chunk: bound_ms((planes[chunk] + rows + 6 * C * P * 4) / C,   # motion rows, traj
                        motion_ops(chunk)),
        fs2_tick: bound_ms(planes[fs2_tick] + rows + 6 * P * 4, fs2_ops(fs2_tick)),
        fs2_chunk: bound_ms((planes[fs2_chunk] + rows + 7 * C * P * 4) / C,  # noise, traj
                            fs2_ops(fs2_chunk)),
    }


def icp_bound(batch):
    """Bound per call of the ICP search on ``(pre, target, source_valid,
    target_valid)``: source and target points and flags read, distances and
    indices written; NN_OPS per source point and valid target."""
    pre, tgt, _, tv = batch
    b, n, mt = pre.shape[0], pre.shape[1], tgt.shape[1]
    nbytes = b * (n * 8 + mt * 8 + mt + n * 8)
    return bound_ms(nbytes, NN_OPS * n * int(tv.sum()))


def icp_library(batch):
    """``torch.cdist`` then a masked ``min``: the nearest library
    counterpart of the ICP search (three calls, not one)."""
    import torch

    pre, tgt, _, tv = batch
    d = torch.cdist(pre, tgt)
    d.masked_fill_(~tv[:, None, :], torch.inf)
    return d.min(dim=-1)


def fused_icp_args(batch):
    """``(source, target, source_valid, target_valid, normals, normal_valid)``
    of a batch of cloud pairs, the normals as ``proposal/icp.py`` gives them
    to the fused kernel."""
    from fastslam_tpu_torch.proposal.icp import estimate_normals

    pre, tgt, sv, tv = batch
    normals, n_ok = estimate_normals(tgt, tv)
    return pre, tgt, sv, tv, normals.contiguous(), n_ok.contiguous()


def online_batch(batch, tick=ONLINE_TICK):
    """The two pairs the online loop matches at ``tick``: scan t-1 -> t and
    scan t-2 -> t, warm-started as the replay's batch is."""
    n1 = (batch[0].shape[0] + 1) // 2          # the T-1 single-step pairs come first
    pick = [tick - 1, n1 + tick - 2]
    return tuple(t[pick].contiguous() for t in batch)


def old_point_to_line(pre, tgt, sv, tv):
    """The point-to-line loop as the port ran it before the fused kernel:
    per iteration one search launch and ~45 eager ops, with a host check of
    convergence every 2 iterations (``proposal/icp.py:_iterate``)."""
    import torch

    from fastslam_tpu_torch.proposal import icp

    cfg = adaptive_config()
    normals, n_ok = icp.estimate_normals(tgt, tv)
    sw = sv.to(pre.dtype)
    nq = torch.cat([normals, n_ok.to(pre.dtype)[..., None]], dim=-1)

    def body(src):
        dist, idx = icp.nearest_neighbors(src, tgt, tv)
        q = icp._gather_points(tgt, idx)
        ng = icp._gather_points(nq, idx)
        n = ng[..., :2]
        w = sw * ng[..., 2]
        r = (src[..., 0] - q[..., 0]) * n[..., 0] + (src[..., 1] - q[..., 1]) * n[..., 1]
        j0 = src[..., 0] * n[..., 1] - src[..., 1] * n[..., 0]
        j1, j2 = n[..., 0], n[..., 1]
        h00 = torch.sum(w * j0 * j0, dim=-1) + 1e-9
        h01 = torch.sum(w * j0 * j1, dim=-1)
        h02 = torch.sum(w * j0 * j2, dim=-1)
        h11 = torch.sum(w * j1 * j1, dim=-1) + 1e-9
        h12 = torch.sum(w * j1 * j2, dim=-1)
        h22 = torch.sum(w * j2 * j2, dim=-1) + 1e-9
        b0 = -torch.sum(w * j0 * r, dim=-1)
        b1 = -torch.sum(w * j1 * r, dim=-1)
        b2 = -torch.sum(w * j2 * r, dim=-1)
        c00 = h11 * h22 - h12 * h12
        c01 = h02 * h12 - h01 * h22
        c02 = h01 * h12 - h02 * h11
        det = h00 * c00 + h01 * c01 + h02 * c02
        det = torch.where(torch.abs(det) > 1e-12, det, 1e-12)
        c11 = h00 * h22 - h02 * h02
        c12 = h01 * h02 - h00 * h12
        c22 = h00 * h11 - h01 * h01
        theta = (c00 * b0 + c01 * b1 + c02 * b2) / det
        tx = (c01 * b0 + c11 * b1 + c12 * b2) / det
        ty = (c02 * b0 + c12 * b1 + c22 * b2) / det
        err = torch.sum(dist * w, dim=-1) / torch.clamp_min(torch.sum(w, dim=-1), 1e-12)
        return theta, torch.stack([tx, ty], dim=-1), err

    return icp._iterate(body, pre, cfg.icp_max_iterations, cfg.icp_tolerance)


def fused_icp_bound(args, iters):
    """Bound per call of the fused point-to-line ICP on ``args``
    (:func:`fused_icp_args`) with the iterations ``iters`` each pair ran:
    points, normals and flags read once, four outputs written; per iteration
    NN_OPS per source point and valid target and ICP_POINT_OPS per source
    point."""
    pre, tgt, _, tv = args[:4]
    b, n, mt = pre.shape[0], pre.shape[1], tgt.shape[1]
    nbytes = b * (n * 8 + n + mt * 8 + mt + mt * 8 + mt + 16)
    valid = tv.sum(dim=1).to(iters.dtype)
    ops = int((iters.long() * n * (NN_OPS * valid.long() + ICP_POINT_OPS)).sum())
    return bound_ms(nbytes, ops)


def at_icp_geometry(geometry, run):
    """``run()`` with the fused ICP kernel launched at ``geometry`` (threads
    per pair, lanes per point) in place of the wrapper's own."""
    from fastslam_tpu_torch.core import cuda_kernels

    saved = cuda_kernels.ICP_THREADS, cuda_kernels.ICP_LANES
    cuda_kernels.ICP_THREADS, cuda_kernels.ICP_LANES = geometry
    try:
        return run()
    finally:
        cuda_kernels.ICP_THREADS, cuda_kernels.ICP_LANES = saved


def same_outputs(tag, got, want):
    """Every output equal, NaN where the other has NaN (an all-invalid
    target's mean error)."""
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        nan = torch.isnan(w) if w.is_floating_point() else torch.zeros_like(w, dtype=torch.bool)
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(
                torch.isnan(g) if g.is_floating_point() else nan, nan) \
                or not torch.equal(g[~nan], w[~nan]):
            raise AssertionError(f"{tag}: output {i} differs from the plain version")


def profiled_device_us(fn, kernel, reps=20):
    """Mean device time of ``kernel`` per call of ``fn`` under
    ``torch.profiler`` (CUPTI), or None when it records no such event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                for e in prof.key_averages() if kernel in e.key)
    return total / reps if total else None


def phase9(gen, ms, batch):
    import torch

    from fastslam_tpu_torch.core import cuda_kernels, kernels

    cfg = config()
    state = seeded_state(cfg, gen, ms)
    d = kernels.draw(gen, P, C)
    noisy_rot = torch.zeros((C, P), device=DEVICE)
    noisy_trans = 0.4 + cfg.translation_noise * d.trans
    z, zv = tiled(ms)
    sk, sp = state.clone(), state.clone()
    tick = lambda fn: (lambda s: fn(state.poses, *args_of(s), ms.range_bearing,
                                    ms.valid, cfg))
    chunk = lambda fn: (lambda s: fn(state.poses, state.log_weights, *args_of(s)[1:],
                                     z, zv, noisy_rot, noisy_trans, cfg))
    fcfg = config(proposal_mode="fastslam2")
    pred, noise, s_t2, s_r2, fxy, _ = fs2_tick_inputs(fcfg, gen, state, None)
    cnoise, prior, _ = fs2_chunk_inputs(fcfg, gen)
    fs2_tick = lambda fn: (lambda s: fn(pred, *args_of(s), ms.range_bearing, ms.valid,
                                        noise, s_t2, s_r2, fxy, fcfg))
    fs2_chunk = lambda fn: (lambda s: fn(state.poses, state.log_weights,
                                         *args_of(s)[1:], z, zv, cnoise, *prior, fcfg))
    pre, tgt, _, tv = batch
    nn = lambda fn: (lambda _: fn(pre, tgt, tv))
    # plain, kernel, kernel, plain: the card's clocks drift between runs; a
    # filter kernel's footprint is read on the state its timing starts from
    t, fp = {}, {}
    for name, fn, s, reps in (
        ("plain_nn", nn(cuda_kernels.icp_correspondences_ref), None, 10),
        ("plain_tick", tick(cuda_kernels.fused_update_planes_ref), sp, 3),
        ("plain_fs2_tick", fs2_tick(cuda_kernels.fused_fs2_planes_ref), sp, 3),
        ("fused_update_planes", tick(cuda_kernels.fused_update_planes), sk, 20),
        ("fused_fs2_planes", fs2_tick(cuda_kernels.fused_fs2_planes), sk, 20),
        ("fused_update_planes_multi", chunk(cuda_kernels.fused_update_planes_multi), sk, 5),
        ("fused_fs2_planes_multi", fs2_chunk(cuda_kernels.fused_fs2_planes_multi), sk, 5),
        ("plain_chunk", chunk(cuda_kernels.fused_update_planes_multi_ref), sp, 2),
        ("plain_fs2_chunk", fs2_chunk(cuda_kernels.fused_fs2_planes_multi_ref), sp, 2),
        ("nn", nn(cuda_kernels.icp_correspondences), None, 50),
        ("library_nn", lambda _: icp_library(batch), None, 20),
        ("nn_again", nn(cuda_kernels.icp_correspondences), None, 50),
    ):
        if s is sk:
            fp[name] = footprint(fn, s)
        t[name] = time_ms(lambda: fn(s), reps)
    times = {
        "fused_update_planes": (t["fused_update_planes"], t["plain_tick"], None),
        "fused_update_planes_multi": (t["fused_update_planes_multi"] / C,
                                      t["plain_chunk"] / C, None),
        "fused_fs2_planes": (t["fused_fs2_planes"], t["plain_fs2_tick"], None),
        "fused_fs2_planes_multi": (t["fused_fs2_planes_multi"] / C,
                                   t["plain_fs2_chunk"] / C, None),
    }
    bounds = filter_bounds(fp)
    for name, (k, pl, _) in times.items():
        b, by = bounds[name]
        slots, written = fp[name]
        phase(9, f"{name}: kernel {k:.4f} ms/tick, plain {pl:.4f} ms/tick, bound "
                 f"{b:.4f} ms/tick ({by}; per particle {slots / P:.2f} occupied "
                 f"slots read, {written / P:.2f} written) "
                 f"(P={P} L={L} M={M}{f' C={C}' if 'multi' in name else ''})")
    for name, fn in (("fused_fs2_planes", fs2_tick(cuda_kernels.fused_fs2_planes)),
                     ("fused_fs2_planes_multi", fs2_chunk(cuda_kernels.fused_fs2_planes_multi))):
        us = profiled_device_us(lambda: fn(sk), f"{name}_kernel", reps=5)
        ticks = C if "multi" in name else 1
        phase(9, f"{name}: device time per launch under torch.profiler: "
                 + (f"{us:.2f} us ({us / ticks / 1e3:.4f} ms/tick)" if us is not None
                    else "no device event seen"))
    fs2_geometry_sweep(sk, fs2_tick, fs2_chunk)
    us = profiled_device_us(lambda: cuda_kernels.fused_update_planes(
        state.poses, *args_of(sk), ms.range_bearing, ms.valid, cfg),
        "fused_update_planes_kernel", reps=5)
    phase(9, "fused_update_planes: device time per launch under torch.profiler: "
             + (f"{us:.2f} us" if us is not None else "no device event seen"))
    us = profiled_device_us(lambda: chunk(cuda_kernels.fused_update_planes_multi)(sk),
                            "fused_update_planes_multi_kernel", reps=5)
    phase(9, "fused_update_planes_multi: device time per launch under torch.profiler: "
             + (f"{us:.2f} us ({us / C / 1e3:.4f} ms/tick)" if us is not None
                else "no device event seen"))
    motion_geometry_sweep(sk, tick, chunk)
    device_us = profiled_device_us(lambda: cuda_kernels.icp_correspondences(pre, tgt, tv),
                                   "icp_nn_kernel")
    phase(9, f"{ICP}: device time per launch under torch.profiler: "
             + (f"{device_us:.2f} us" if device_us is not None else "no device event seen"))
    times[ICP] = (t["nn"], t["plain_nn"], t["library_nn"])
    bounds[ICP] = icp_bound(batch)
    phase(9, f"{ICP}: kernel {t['nn']:.4f} ms/call (again {t['nn_again']:.4f}), plain "
             f"{t['plain_nn']:.4f} ms/call, torch.cdist + masked min "
             f"{t['library_nn']:.4f} ms/call, bound {bounds[ICP][0]:.6f} ms "
             f"({bounds[ICP][1]}) ({pre.shape[0]} pairs, {pre.shape[1]} x "
             f"{tgt.shape[1]} points)")
    times[FUSED_ICP], bounds[FUSED_ICP] = fused_icp_times(batch)
    return times, bounds


def fused_icp_times(batch):
    """The fused point-to-line kernel per call at the replay and online
    batches, beside its plain version, the old per-iteration path and the
    whole proposal call; then each geometry of ICP_GEOMETRIES, bit for bit
    and timed in turns.  Returns the replay batch's (kernel, plain, None)
    times and bound."""
    from fastslam_tpu_torch.core import cuda_kernels
    from fastslam_tpu_torch.proposal import icp

    cfg = adaptive_config()
    tol, max_iter = cfg.icp_tolerance, cfg.icp_max_iterations
    runs = {"replay": fused_icp_args(batch), "online": fused_icp_args(online_batch(batch))}
    out = {}
    for name, args in runs.items():
        fused = lambda: cuda_kernels.icp_point_to_line_fused(*args, max_iter, tol)
        t = {}
        for key, fn, reps in (
                ("plain", lambda: cuda_kernels.icp_point_to_line_ref(*args, max_iter, tol), 3),
                ("old", lambda: old_point_to_line(*args[:4]), 10),
                ("kernel", fused, 50),
                ("proposal", lambda: icp.icp_point_to_line(*args[:4], cfg), 50),
                ("kernel_again", fused, 50),
                ("old_again", lambda: old_point_to_line(*args[:4]), 10)):
            t[key] = time_ms(fn, reps)
        iters = fused()[3]
        bound = fused_icp_bound(args, iters)
        us = profiled_device_us(fused, "icp_point_to_line_kernel")
        out[name] = (t, bound)
        phase(9, f"{FUSED_ICP} {name} batch ({args[0].shape[0]} pairs, {args[0].shape[1]} x "
                 f"{args[1].shape[1]} points, {int(iters.sum())} iterations, at most "
                 f"{int(iters.max())}): kernel {t['kernel']:.4f} ms/call (again "
                 f"{t['kernel_again']:.4f}; device "
                 + (f"{us:.2f} us" if us is not None else "not seen")
                 + f"), the whole proposal call (normals included) {t['proposal']:.4f} ms, "
                 f"old per-iteration path {t['old']:.4f} ms (again {t['old_again']:.4f}), "
                 f"plain {t['plain']:.4f} ms, bound {bound[0]:.6f} ms ({bound[1]})")
    chosen = (cuda_kernels.ICP_THREADS, cuda_kernels.ICP_LANES)
    for name, args in runs.items():
        want = cuda_kernels.icp_point_to_line_ref(*args, max_iter, tol)
        for g in ICP_GEOMETRIES:
            same_outputs(f"fused ICP {name} at {g}", at_icp_geometry(
                g, lambda: cuda_kernels.icp_point_to_line_fused(*args, max_iter, tol)), want)
    ms = {}
    for g in ICP_GEOMETRIES + ICP_GEOMETRIES[::-1]:
        for name, args in runs.items():
            ms.setdefault((g, name), []).append(at_icp_geometry(g, lambda: time_ms(
                lambda: cuda_kernels.icp_point_to_line_fused(*args, max_iter, tol), 30)))
    for g in ICP_GEOMETRIES:
        phase(9, f"fused ICP geometry {g[0]} threads x {g[1]} lanes"
                 f"{' (ICP_THREADS, ICP_LANES)' if g == chosen else ''}: equal to the plain "
                 f"version bit for bit; "
                 + ", ".join(f"{name} {min(ms[g, name]):.4f} ms/call (runs "
                             f"{' / '.join(f'{x:.4f}' for x in ms[g, name])})"
                             for name in runs))
    t, bound = out["replay"]
    return (t["kernel"], t["plain"], None), bound


def at_geometry(geometry, run):
    """``run()`` with the fs2 kernels launched at ``geometry`` (tile, lanes)
    in place of the wrappers' own."""
    from fastslam_tpu_torch.core import cuda_kernels

    saved = cuda_kernels.FS2_TILE, cuda_kernels.FS2_LANES
    cuda_kernels.FS2_TILE, cuda_kernels.FS2_LANES = geometry
    try:
        return run()
    finally:
        cuda_kernels.FS2_TILE, cuda_kernels.FS2_LANES = saved


def fs2_geometry_sweep(state, fs2_tick, fs2_chunk):
    """The fs2 kernels at each launch geometry of FS2_GEOMETRIES: every
    output bit for bit against the plain versions on a copy of ``state``,
    then ms per tick, in turns over the geometries forward and backward."""
    from fastslam_tpu_torch.core import cuda_kernels

    chosen = cuda_kernels.fs2_launch_geometry(L, M)
    runs = {"per-tick": (fs2_tick(cuda_kernels.fused_fs2_planes),
                         fs2_tick(cuda_kernels.fused_fs2_planes_ref), 20, 1),
            "chunked": (fs2_chunk(cuda_kernels.fused_fs2_planes_multi),
                        fs2_chunk(cuda_kernels.fused_fs2_planes_multi_ref), 5, C)}
    for name, (kernel, plain, _, _) in runs.items():
        want = plain(state.clone())
        for g in FS2_GEOMETRIES:
            compare_exact(f"fs2 {name} at {g}", at_geometry(g, lambda: kernel(state.clone())),
                          want)
    ms = {}
    for g in FS2_GEOMETRIES + FS2_GEOMETRIES[::-1]:
        for name, (kernel, _, reps, ticks) in runs.items():
            ms.setdefault((g, name), []).append(
                at_geometry(g, lambda: time_ms(lambda: kernel(state), reps)) / ticks)
    for g in FS2_GEOMETRIES:
        phase(9, f"fs2 launch geometry {g[0]} particles x {g[1]} lanes"
                 f"{' (FS2_TILE, FS2_LANES)' if g == chosen else ''}: equal to the plain "
                 f"versions bit for bit; "
                 + ", ".join(f"{name} {min(ms[g, name]):.4f} ms/tick (runs "
                             f"{' / '.join(f'{x:.4f}' for x in ms[g, name])})"
                             for name in runs))


def at_motion_geometry(geometry, run):
    """``run()`` with the motion kernels launched at ``geometry`` (tile,
    lanes) in place of the wrappers' own."""
    from fastslam_tpu_torch.core import cuda_kernels

    saved = cuda_kernels.MOTION_TILE, cuda_kernels.MOTION_LANES
    cuda_kernels.MOTION_TILE, cuda_kernels.MOTION_LANES = geometry
    try:
        return run()
    finally:
        cuda_kernels.MOTION_TILE, cuda_kernels.MOTION_LANES = saved


def motion_geometry_sweep(state, tick, chunk):
    """The motion kernels at each launch geometry of MOTION_GEOMETRIES:
    every output bit for bit against the plain versions at the bench state
    (production) and on the ragged L=64 states of phases 2 and 3 (both
    modes), then ms per tick (production), in turns over the geometries
    forward and backward."""
    import torch

    from fastslam_tpu_torch.core import cuda_kernels

    chosen = cuda_kernels.motion_launch_geometry(L, M, False)
    runs = {"per-tick": (tick(cuda_kernels.fused_update_planes),
                         tick(cuda_kernels.fused_update_planes_ref), 20, 1),
            "chunked": (chunk(cuda_kernels.fused_update_planes_multi),
                        chunk(cuda_kernels.fused_update_planes_multi_ref), 5, C)}
    want = {name: plain(state.clone()) for name, (_, plain, _, _) in runs.items()}
    ragged = [ragged_motion_inputs(64, parity, seed=90 + parity) for parity in (False, True)]
    ragged_want = [cuda_kernels.fused_update_planes_ref(poses, *args_of(s.clone()), z, zv, c)
                   for c, s, poses, z, zv in ragged]
    gen = torch.Generator(device=DEVICE).manual_seed(92)
    chunks = [ragged_motion_chunk(64, parity, 92 + parity, gen) for parity in (False, True)]
    chunks_want = [run_chunk(cuda_kernels.fused_update_planes_multi_ref, *a) for a in chunks]
    for g in MOTION_GEOMETRIES:
        for name, (kernel, _, _, _) in runs.items():
            compare_exact(f"motion {name} at {g}",
                          at_motion_geometry(g, lambda: kernel(state.clone())), want[name])
        for (c, s, poses, z, zv), w in zip(ragged, ragged_want):
            compare_exact(f"motion per-tick at {g}, parity {c.parity_mode}", at_motion_geometry(
                g, lambda: cuda_kernels.fused_update_planes(poses, *args_of(s.clone()), z, zv,
                                                            c)), w)
        for a, w in zip(chunks, chunks_want):
            compare_exact(f"motion chunked at {g}, parity {a[0].parity_mode}",
                          at_motion_geometry(g, lambda: run_chunk(
                              cuda_kernels.fused_update_planes_multi, *a)), w)
    ms = {}
    for g in MOTION_GEOMETRIES + MOTION_GEOMETRIES[::-1]:
        for name, (kernel, _, reps, ticks) in runs.items():
            ms.setdefault((g, name), []).append(
                at_motion_geometry(g, lambda: time_ms(lambda: kernel(state), reps)) / ticks)
    for g in MOTION_GEOMETRIES:
        phase(9, f"motion launch geometry {g[0]} particles x {g[1]} lanes"
                 f"{' (MOTION_TILE, MOTION_LANES)' if g == chosen else ''}: equal to the "
                 f"plain versions bit for bit; "
                 + ", ".join(f"{name} {min(ms[g, name]):.4f} ms/tick (runs "
                             f"{' / '.join(f'{x:.4f}' for x in ms[g, name])})"
                             for name in runs))


def adaptive_config(**kw):
    return config(proposal_mode="fastslam2", use_icp_proposal=True,
                  adaptive_proposal_floors=True, icp_blend=0.0, **kw)


def replay_icp_batch(log):
    """The cloud pairs the adaptive replay's ICP stage searches first:
    the 299 single-step and 298 two-step pairs of the drive, warm-started."""
    import torch

    from fastslam_tpu_torch.app.runner import icp_stage_pairs, odometry, scan_points

    pts, valid = scan_points(log)
    rots, trans = odometry(log, adaptive_config())
    pre, tgt, sv, tv, _, _ = icp_stage_pairs(
        torch.from_numpy(pts).to(DEVICE), torch.from_numpy(valid).to(DEVICE),
        rots, trans, two_step=True)
    return pre, tgt.contiguous(), sv.contiguous(), tv.contiguous()


def phase10(batch):
    """The ICP kernel against its plain version: exact indices and distances."""
    import torch

    from fastslam_tpu_torch.core import cuda_kernels

    gen = torch.Generator(device=DEVICE).manual_seed(10)
    src = torch.randn((64, 180, 2), generator=gen, device=DEVICE) * 3.0
    tgt = torch.randn((64, 180, 2), generator=gen, device=DEVICE) * 3.0
    tgt[:, 90:135] = tgt[:, :45]                   # duplicate targets: ties
    src[:, 0] = tgt[:, 0]                          # a distance of 0
    tv = torch.rand((64, 180), generator=gen, device=DEVICE) < 0.7
    tv[5] = False                                  # a cloud with no valid target
    large = (torch.randn((4096, 2), generator=gen, device=DEVICE) * 5.0,
             torch.randn((8192, 2), generator=gen, device=DEVICE) * 5.0,
             torch.rand(8192, generator=gen, device=DEVICE) < 0.9)
    many = (torch.randn((70_000, 6, 2), generator=gen, device=DEVICE),
            torch.randn((70_000, 8, 2), generator=gen, device=DEVICE),
            torch.rand((70_000, 8), generator=gen, device=DEVICE) < 0.8)
    worst = 0.0
    for name, (s, t, v) in (("replay batch", (batch[0], batch[1], batch[3])),
                            ("random ties/invalid", (src, tgt, tv)),
                            ("large pair 4096 x 8192", large),
                            ("70000 pairs, past a grid dimension", many)):
        got = cuda_kernels.icp_correspondences(s, t, v)
        torch.cuda.synchronize()
        want = cuda_kernels.icp_correspondences_ref(s, t, v)
        bad_idx = int((got[1] != want[1]).sum())
        finite = torch.isfinite(want[0])
        if not torch.equal(torch.isfinite(got[0]), finite):
            raise AssertionError(f"ICP {name}: infinite distances differ")
        err = float((got[0][finite] - want[0][finite]).abs().max()) if finite.any() else 0.0
        if bad_idx or err:
            raise AssertionError(f"ICP {name}: {bad_idx} index mismatches, max abs "
                                 f"err {err:.3e}")
        worst = max(worst, err)
        phase(10, f"ICP NN {name} {tuple(s.shape)} vs {tuple(t.shape)}: index "
                  f"mismatches 0, max abs err {err:.3e}, no valid target in "
                  f"{int((~v.any(dim=-1)).sum()) if v.dim() == 2 else int(not v.any())} "
                  f"cloud(s)")
    return worst, phase10_fused(batch, (src, tgt, tv), gen)


def phase10_sin_cos(gen):
    """The fused kernel's rotation (sinf, cosf built with -fmad=false)
    against torch.sin / torch.cos of the same CUDA tensor, bit for bit."""
    import math

    import torch

    from fastslam_tpu_torch.core import cuda_kernels

    x = (torch.rand(SIN_COS_VALUES, generator=gen, device=DEVICE) * 2.0 - 1.0) * (4 * math.pi)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    edges = [0.0, -0.0, math.pi, math.pi / 2, 2 * math.pi, 4 * math.pi, 1e-38, 1e-45, 1e-30,
             1e-4, 0.5, 1e4, 1e30, 3.4e38, math.inf, math.nan]
    edges = torch.stack([f32(v) for v in edges])
    edges = torch.cat([edges, -edges, torch.nextafter(edges, f32(0.0)),
                       torch.nextafter(edges, f32(math.inf))]).to(DEVICE)
    x = torch.cat([x, edges])
    got = cuda_kernels.icp_rotation_sin_cos(x)
    torch.cuda.synchronize()
    want = (torch.sin(x), torch.cos(x))
    off = [int(((g != w) & ~(torch.isnan(g) & torch.isnan(w))).sum())
           for g, w in zip(got, want)]
    if any(off):
        raise AssertionError(f"sinf/cosf differ from torch.sin/torch.cos on {off[0]} / {off[1]} "
                             f"of {x.numel()} values")
    phase(10, f"the fused ICP's sinf/cosf (-fmad=false) equal torch.sin/torch.cos on the card "
              f"bit for bit on {SIN_COS_VALUES} uniform values in [-4 pi, 4 pi] and "
              f"{edges.numel()} edges (0, denormals, pi multiples, 1e30, inf, NaN, neighbours)")


def phase10_fused(batch, random_clouds, gen):
    """The fused point-to-line kernel against its plain version on the card:
    theta, translation, mean error and iterations equal."""
    import torch

    from fastslam_tpu_torch.core import cuda_kernels
    from fastslam_tpu_torch.proposal.icp import rotate_points

    cfg = adaptive_config()
    tol, max_iter = cfg.icp_tolerance, cfg.icp_max_iterations
    src, tgt, tv = random_clouds
    sv = torch.rand(src.shape[:2], generator=gen, device=DEVICE) < 0.9
    invalid = tuple(t.clone() for t in online_batch(batch))
    invalid[3][0] = False                                 # an all-invalid target
    big_t = torch.randn((1, 8192, 2), generator=gen, device=DEVICE) * 5.0
    big_s = rotate_points(big_t[:, :4096], 0.02) + torch.tensor([0.05, -0.03], device=DEVICE) \
        + 0.01 * torch.randn((1, 4096, 2), generator=gen, device=DEVICE)
    big = (big_s.contiguous(), big_t, torch.ones((1, 4096), dtype=torch.bool, device=DEVICE),
           torch.rand((1, 8192), generator=gen, device=DEVICE) < 0.9)
    cases = [("replay batch", batch, tol)]
    cases += [(f"online batch, tick {t}", online_batch(batch, t), tol) for t in (2, 50, 299)]
    cases += [("random ties/invalid", (src, tgt, sv, tv), tol),
              ("all-invalid target", invalid, tol),
              ("8 replay pairs to max_iter (tol 0)", tuple(t[:8] for t in batch), 0.0),
              ("large pair 4096 x 8192", big, tol)]
    worst = 0.0
    for name, pairs, tl in cases:
        args = fused_icp_args(pairs)
        got = cuda_kernels.icp_point_to_line_fused(*args, max_iter, tl)
        torch.cuda.synchronize()
        want = cuda_kernels.icp_point_to_line_ref(*args, max_iter, tl)
        same_outputs(f"fused ICP {name}", got, want)
        iters = want[3]
        if tl == 0.0 and not bool((iters == max_iter).all()):
            raise AssertionError(f"fused ICP {name}: iterations {iters.tolist()}")
        p2, smem, in_scratch = cuda_kernels.icp_fused_layout(args[0].shape[1], args[1].shape[1])
        phase(10, f"fused ICP {name} ({args[0].shape[0]} pairs, {args[0].shape[1]} x "
                  f"{args[1].shape[1]} points; {smem} B shared"
                  f"{', per-point arrays in scratch' if in_scratch else ''}"
                  f"{', targets in tiles' if args[1].shape[1] > cuda_kernels.ICP_TGT_TILE else ''}"
                  f"): theta, translation, mean error and iterations equal to the plain version "
                  f"({int(iters.min())}-{int(iters.max())} iterations, "
                  f"{int(torch.isnan(want[2]).sum())} NaN mean errors)")
    return worst


def zeroed_run(run):
    """``run()`` with every launch counter set to 0 just before; returns its
    result, the counters just after, and the wall time."""
    import torch

    from fastslam_tpu_torch.core import cuda_kernels

    for k in cuda_kernels.LAUNCHES:
        cuda_kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, dict(cuda_kernels.LAUNCHES), time.perf_counter() - t0


def check_icp_launches(tag, launches, expected):
    """Exactly ``expected`` launches (0 for the kernels it does not name):
    one fused ICP launch per ICP call, and no launch of the search alone."""
    want = {k: expected.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")


def check_estimates(tag, hist, ate_bar):
    import numpy as np

    est = np.asarray(hist.est_poses)
    if est.shape != (300, 3) or not np.isfinite(est).all():
        raise AssertionError(f"{tag}: estimates shape {est.shape}, finite "
                             f"{np.isfinite(est).all()}")
    ate = hist.metrics()["ate_rmse_m"]
    if not ate < ate_bar:
        raise AssertionError(f"{tag}: ATE {ate} m >= {ate_bar} m")
    return est, ate


def phase11(log, fs2_ate):
    import numpy as np
    import torch

    from fastslam_tpu_torch.app.runner import (
        icp_floor_stage, odometry, replay_chunked, scan_points,
    )
    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld

    cfg = adaptive_config()
    replay = lambda slip=(0.0, 0.0): replay_chunked(
        log, cfg, chunk_size=ADAPTIVE_C, rng=0, device=DEVICE, odometry_noise=slip)
    hist, launches, wall = zeroed_run(replay)
    check_icp_launches("adaptive replay", launches, ADAPTIVE_LAUNCHES)
    est, ate = check_estimates("adaptive replay", hist, 0.05)
    fixed = replay_chunked(log, config(proposal_mode="fastslam2"), chunk_size=ADAPTIVE_C,
                           rng=0, device=DEVICE).metrics()["ate_rmse_m"]
    phase(11, f"replay_chunked fs2+ICP+adaptive 300 ticks P={P} L={L} chunk "
              f"{ADAPTIVE_C} on cuda: ATE {ate:.4f} m (fs2 replay at fixed floors: "
              f"{fixed:.4f} m at chunk {ADAPTIVE_C}, {fs2_ate:.4f} m at chunk {C}; "
              f"adaptive beats fixed: {ate < fixed}), wall {wall:.2f} s, final floors "
              f"{tuple(round(f, 6) for f in hist.final_floors)}, launches {launches}")
    again = np.asarray(replay().est_poses)
    if not np.array_equal(again, est):
        raise AssertionError(f"adaptive replay: a second run differs by "
                             f"{np.abs(again - est).max():.3e}")
    phase(11, "a second run gives the same 300 estimates bit for bit")
    slipped, slip_launches, slip_wall = zeroed_run(lambda: replay(SLIP))
    check_icp_launches("adaptive replay with slip", slip_launches, ADAPTIVE_LAUNCHES)
    _, slip_ate = check_estimates("adaptive replay with slip", slipped, 0.10)
    phase(11, f"with wheel slip {SLIP}: ATE {slip_ate:.4f} m, wall {slip_wall:.2f} s, "
              f"fused ICP launches {slip_launches[FUSED_ICP]}")

    # the ICP stage and a noise-free motion + ICP replay, card against CPU
    pts, valid = scan_points(log)
    rots, trans = odometry(log, cfg)
    rng = np.random.default_rng(3)
    rots = np.where(rots != 0, rots + rng.normal(0, SLIP[0], 300), 0).astype(np.float32)
    trans = np.where(trans != 0, trans + rng.normal(0, SLIP[1], 300), 0).astype(np.float32)
    v_active = np.concatenate([[False], np.asarray(log.cmd_v[:-1]) != 0])
    small = FastSLAMConfig(num_particles=256, max_landmarks=16, parity_mode=False,
                           proposal_mode="fastslam2", use_icp_proposal=True,
                           adaptive_proposal_floors=True)
    stage = {dev: icp_floor_stage(torch.from_numpy(pts).to(dev),
                                  torch.from_numpy(valid).to(dev), rots, trans,
                                  v_active, small)
             for dev in (DEVICE, "cpu")}
    # the floors are medians of ICP residuals, which differ in the last bits
    # between the card's and the CPU's sums: 1e-5.  The dial is a ramp of the
    # floors of slope 1 / (hi - lo) = 400, so on each tick it may differ by
    # that slope times the larger of its two floors' differences, plus the
    # float32 rounding of the stored floors and dial (1e-6)
    errs = {}
    for name, g, c in zip(stage["cpu"]._fields, stage[DEVICE], stage["cpu"]):
        errs[name] = float(np.abs(g - c).max())
        if name != "dial" and not errs[name] <= 1e-5:
            raise AssertionError(f"ICP stage {name}: cuda vs cpu max diff {errs[name]}")
    slope = 1.0 / (small.fs2_dial_hi_floor - small.fs2_dial_lo_floor)
    floor_diff = np.maximum(*(np.abs(getattr(stage[DEVICE], f) - getattr(stage["cpu"], f))
                              for f in ("floors_xy", "floors_th")))
    dial_diff = np.abs(stage[DEVICE].dial - stage["cpu"].dial)
    dial_limit = slope * floor_diff.astype(np.float64) + 1e-6
    if (dial_diff > dial_limit).any():
        raise AssertionError(f"ICP stage dial: cuda vs cpu past slope x floor difference "
                             f"on {int((dial_diff > dial_limit).sum())} ticks, max diff "
                             f"{errs['dial']}")
    motion_icp = small.replace(proposal_mode="motion", adaptive_proposal_floors=False,
                               icp_blend=0.5, rotation_noise=0.0, translation_noise=0.0,
                               warmup_iterations=8)
    short = record_log(SimWorld(seed=3), num_ticks=52)
    on = {dev: np.asarray(replay_chunked(short, motion_icp, chunk_size=8,
                                         device=dev).est_poses)
          for dev in (DEVICE, "cpu")}
    diff = float(np.abs(on[DEVICE] - on["cpu"]).max())
    if not diff < 1e-4:
        raise AssertionError(f"noise-free motion + ICP replay: cuda vs cpu max diff {diff}")
    phase(11, f"ICP stage with slip, cuda vs cpu: max diff "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (the dial's limit on its worst tick "
              f"{dial_limit[np.argmax(dial_diff)]:.3e})"
              + f"; noise-free motion + ICP replay (P=256, 52 ticks): max diff {diff:.3e}")
    return launches


def online_run(log, cfg, **kw):
    """``run_driver`` over ``log`` on the card, counters zeroed just before."""
    from fastslam_tpu_torch.app.runner import run_driver
    from fastslam_tpu_torch.drivers.replay import ReplayDriver

    return zeroed_run(lambda: run_driver(ReplayDriver(log), cfg, rng=0, device=DEVICE, **kw))


def check_fused(tag, log, hist, launches, ate_bar):
    """One graph replay per tick after the eager first one, the fused
    path's launches, finite estimates under ``ate_bar``."""
    check_icp_launches(tag, launches, ONLINE_FUSED_LAUNCHES)
    if hist.graph_replays != len(log) - 1 or "icp_refine" in hist.stage_seconds:
        raise AssertionError(f"{tag}: {hist.graph_replays} graph replays, stages "
                             f"{sorted(hist.stage_seconds)}")
    return check_estimates(tag, hist, ate_bar)


def same_estimates(tag, got, want):
    import numpy as np

    got = np.asarray(got.est_poses) if hasattr(got, "est_poses") else got
    if not np.array_equal(got, want):
        raise AssertionError(f"{tag}: estimates differ by {np.abs(got - want).max():.3e}")


def phase12(log, card):
    """The online loop: the split path, then the fused tick (graph)."""
    cfg = adaptive_config(fuse_online_tick=False)
    hist, launches, wall = online_run(log, cfg)
    check_icp_launches("split online loop", launches, ONLINE_LAUNCHES)
    est, ate = check_estimates("split online loop", hist, 0.05)
    per = {k: v / len(log) * 1e3 for k, v in hist.stage_seconds.items()}
    phase(12, f"split path: run_driver(ReplayDriver) fs2+ICP+adaptive 300 ticks P={P} "
              f"L={L} on {card}: ATE {ate:.4f} m, wall {wall:.2f} s = "
              f"{wall / 300 * 1e3:.2f} ms per tick (host clock: ICP refine "
              f"{per['icp_refine']:.3f}, frontend + step {per['tick']:.3f}), final floors "
              f"{tuple(round(f, 6) for f in hist.final_floors)}, launches {launches}")
    same_estimates("split online loop, second run", online_run(log, cfg)[0], est)
    phase(12, "split path: a second run gives the same 300 estimates bit for bit")

    cfg = adaptive_config()
    fused, fused_launches, fused_wall = online_run(log, cfg)
    fused_est, fused_ate = check_fused("fused online loop", log, fused, fused_launches, 0.05)
    phase(12, f"fused tick (production): the same loop on {card}: ATE {fused_ate:.4f} m, "
              f"wall {fused_wall:.2f} s = {fused_wall / 300 * 1e3:.2f} ms per tick "
              f"({wall / fused_wall:.2f}x the split path), {fused.graph_replays} graph "
              f"replays, final floors {tuple(round(f, 6) for f in fused.final_floors)}, "
              f"launches {fused_launches} (replays counted)")
    again, _, again_wall = online_run(log, cfg)
    same_estimates("fused online loop, second run", again, fused_est)
    eager, eager_launches, eager_wall = online_run(log, cfg, graph=False)
    same_estimates("fused online loop, eager on the card", eager, fused_est)
    if eager.graph_replays or eager_launches != fused_launches:
        raise AssertionError(f"eager fused tick: {eager.graph_replays} replays, launches "
                             f"{eager_launches}")
    phase(12, f"fused tick: a second run ({again_wall / 300 * 1e3:.2f} ms per tick) and the "
              f"eager fused tick on the card ({eager_wall / 300 * 1e3:.2f} ms per tick, no "
              f"graph) give the same 300 estimates bit for bit; max |fused - split| "
              f"{float(abs(fused_est - est).max()):.4f}")
    fused_breakdown(log, card)
    return launches, fused_launches, fused_est, fused_wall


def fused_breakdown(log, card):
    """Where the fused tick's time goes: the device time of one replay of
    its graph (CUDA events), the graph's kernels by device time under
    ``torch.profiler``, and at the bench geometry the cost of the resample
    decided on the device (staircase and identity gather) beside the host
    branch (no resample due), and of the copy back into the static state."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastslam_tpu_torch.app.runner import SLAMRunner
    from fastslam_tpu_torch.core import kernels
    from fastslam_tpu_torch.drivers.replay import ReplayDriver

    cfg = adaptive_config()
    runner = SLAMRunner(cfg, device=DEVICE)
    drv = ReplayDriver(log)
    prev = (0.0, 0.0)
    for _ in range(40):
        scan = drv.get_laser()
        pts, valid = scan.to_points()
        v, w = prev
        prev = drv.commanded_velocity()
        rot, tr = runner.odometry(v, w, scan.timestamp)
        runner.tick_fused(pts, valid, rot, tr, v)
        drv.step()
    graph = runner._fused.graph
    replay_ms = time_ms(graph.replay, 50)
    reps = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    events = [(e.key, getattr(e, "device_time_total", 0.0) / reps / 1e3, e.count / reps)
              for e in prof.key_averages()]
    busy = sum(t for _, t, _ in events)
    top = sorted(events, key=lambda e: -e[1])[:6]
    state = runner.state.clone()
    state = state.replace(log_weights=torch.full_like(state.log_weights, -math.log(P)))
    u0 = torch.full((), 0.3 / P, device=DEVICE)
    host_ms = time_ms(lambda: kernels._normalize_and_resample(state, u0, cfg), 20)
    device_ms = time_ms(
        lambda: kernels._normalize_and_resample(state, u0, cfg, on_device=True), 20)
    target = state.clone()
    pairs = [(getattr(target, k), v) for k, v in state.__dict__.items() if v is not None]
    copy_ms = time_ms(lambda: [d.copy_(x) for d, x in pairs], 20)
    state_mb = sum(v.numel() * v.element_size() for _, v in pairs) / 1e6
    phase(12, f"fused tick's graph on {card}: {replay_ms:.4f} ms of device time per replay "
              f"(CUDA events), {sum(c for _, _, c in events):.0f} kernels and copies per replay "
              f"busy {busy:.4f} ms under torch.profiler; top: "
              + "; ".join(f"{k[:48]} {t:.4f} ms x{c:.0f}" for k, t, c in top))
    phase(12, f"resample decided on the device at P={P} L={L} (no resample due): "
              f"{device_ms:.4f} ms against the host branch's {host_ms:.4f} ms "
              f"(+{device_ms - host_ms:.4f} ms: the staircase and the identity gather of "
              f"{state_mb:.1f} MB); the copy back into the static state {copy_ms:.4f} ms")
    return {"replay_ms": replay_ms, "busy_ms": busy, "gather_ms": device_ms - host_ms,
            "copy_ms": copy_ms}


def phase20(log, card):
    """Corner tracking and the JdeRobot traces on the fused online loop."""
    import glob
    import os

    from fastslam_tpu_torch.io.jderobot_trace import load_hal_trace

    cfg = adaptive_config(track_corners=True)
    hist, launches, wall = online_run(log, cfg)
    _, ate = check_fused("tracked fused loop", log, hist, launches, 0.05)
    eager, _, eager_wall = online_run(log, cfg, graph=False)
    same_estimates("tracked fused loop, eager on the card", eager, hist.est_poses)
    phase(20, f"track_corners on the fused tick, fs2+ICP+adaptive 300 ticks P={P} L={L} on "
              f"{card}: ATE {ate:.4f} m, {wall / 300 * 1e3:.2f} ms per tick, "
              f"{hist.graph_replays} graph replays, equal bit for bit to its eager run "
              f"({eager_wall / 300 * 1e3:.2f} ms per tick); launches {launches}")
    root = os.path.dirname(os.path.abspath(__file__))
    traces = sorted(glob.glob(os.path.join(root, "data", "jderobot", "*.jsonl")))
    if len(traces) != 2:
        raise AssertionError(f"expected the two committed JdeRobot traces, found {traces}")
    total = {}
    for path in traces:
        trace = load_hal_trace(path)
        th, tl, tw = online_run(trace, adaptive_config())
        _, tate = check_fused(f"trace {os.path.basename(path)}", trace, th, tl, TRACE_ATE)
        total = {k: total.get(k, 0) + v for k, v in tl.items()}
        phase(20, f"JdeRobot trace {os.path.basename(path)} ({len(trace)} ticks) on the fused "
                  f"loop, fs2+ICP+adaptive P={P} L={L} on {card}: ATE {tate:.4f} m, "
                  f"{tw / len(trace) * 1e3:.2f} ms per tick, launches {tl}")
    return launches, total


def ring_blocks(s, p_local, gen):
    """S packed particle blocks ``[p_local, 3 + 1 + 6L + 1]`` on the card."""
    import torch

    return [torch.randn((p_local, 3 + 1 + 6 * L + 1), generator=gen, device=DEVICE)
            for _ in range(s)]


def phase13(gen):
    """The exchange kernel against its plain version: exact equality."""
    import torch

    from fastslam_tpu_torch.core import cuda_kernels

    worst = 0.0
    for s, p_local in ((1, P), (2, P // 2), (4, P // 4), (8, P // 8), (8, 12_501)):
        blocks = ring_blocks(s, p_local, gen)
        got = cuda_kernels.ring_halo_exchange(blocks)
        torch.cuda.synchronize()
        want = cuda_kernels.ring_halo_exchange_ref(blocks)
        err = max(float((g - w).abs().max()) for g, w in zip(got[0] + got[1], want[0] + want[1]))
        if err or not all(torch.equal(g, w) for g, w in zip(got[0] + got[1], want[0] + want[1])):
            raise AssertionError(f"ring exchange S={s} P_local={p_local}: max abs err {err}")
        worst = max(worst, err)
        n = blocks[0].numel()
        phase(13, f"ring exchange S={s}, {p_local} particles x {blocks[0].shape[1]} floats "
                  f"per shard ({n} floats, {n % 4} in the scalar tail): equal to the plain "
                  f"copies, max abs err {err}")
    return worst


def phase14():
    """Both distributed resamplers bit for bit against ``resample_state``."""
    import torch

    from fastslam_tpu_torch.parallel import dryrun

    cfg = config()
    for profile, u0 in (("healthy", 0.0042), ("collapsed", 0.0042)):
        t0 = time.perf_counter()
        out = dryrun.check_resamplers(cfg, SHARDS, DEVICE, profile, u0, seed=14)
        torch.cuda.synchronize()
        want_halo = int(profile == "healthy")
        if out != {"ring_launches": 1, "halo_path": want_halo}:
            raise AssertionError(f"resamplers ({profile}): {out}, expected one exchange "
                                 f"launch and halo path {want_halo}")
        phase(14, f"{profile} weights, S={SHARDS}, P={P}, L={L}: ring (exchange kernel, "
                  f"{out['ring_launches']} launch) and halo resamplers equal resample_state "
                  f"bit for bit in every field, {'halo' if want_halo else 'fallback'} path, "
                  f"{time.perf_counter() - t0:.2f} s")


def sharded_config():
    return config(resample_threshold_frac=1.0)


def phase15():
    """The sharded main path at full width, then S=1 and the single-device
    steps on the same draws, bit for bit."""
    import torch

    from fastslam_tpu_torch.core.state import pad_measurements
    from fastslam_tpu_torch.parallel import dryrun

    cfg = sharded_config()
    results, launches, wall = zeroed_run(lambda: dryrun.dryrun_multichip(
        SHARDS, DEVICE, config=cfg, measurements=MEASUREMENTS, chunk=C, ticks=3))
    expected = {k: 0 for k in launches}
    for layout, _, kernel in dryrun.MODES.values():
        expected[kernel] += SHARDS * (3 if layout in ("blocks", "planes") else 1)
    expected[RING] = 1
    if launches != expected:
        raise AssertionError(f"sharded main path launches {launches}, expected {expected}")
    phase(15, f"dryrun_multichip on {SHARDS} shards of the card, P={P} L={L} M={M} C={C}: "
              f"wall {wall:.2f} s, launches {launches}")
    ms = pad_measurements(cfg, MEASUREMENTS, DEVICE)
    others = {n: dryrun.run_steps(cfg, n, DEVICE, ms, chunk=C, ticks=3) for n in (1, None)}
    for mode, r in results.items():
        if mode == "resample":
            continue
        for n, other in others.items():
            o = other[mode]
            same = torch.equal(r["est"], o["est"]) and all(
                (v is None and getattr(o["state"], k) is None)
                or torch.equal(v, getattr(o["state"], k))
                for k, v in r["state"].__dict__.items())
            if not same:
                raise AssertionError(f"{mode}: {SHARDS} shards differ from "
                                     f"{'1 shard' if n else 'the single-device step'}")
        lw = r["state"].log_weights
        phase(15, f"{mode}: launches {r['launches']}, estimates finite, bit for bit the "
                  f"same at S=1 and on the single-device step; final weights "
                  f"{'uniform (resampled)' if bool((lw == lw[0]).all()) else 'spread'}")
    return launches


def phase16(gen):
    """Times: the exchange kernel at S=4 and the sharded chunked steps."""
    import torch

    from fastslam_tpu_torch.core import cuda_kernels, kernels
    from fastslam_tpu_torch.core.state import (
        Measurements, init_planes_state, pad_measurements,
    )
    from fastslam_tpu_torch.parallel.mesh import make_mesh, shard_planes_state
    from fastslam_tpu_torch.parallel.sharded import make_sharded_planes_chunked_step

    blocks = ring_blocks(SHARDS, P // SHARDS, gen)
    stacked = torch.stack(blocks)
    t = {}
    for name, fn, reps in (("plain", lambda: cuda_kernels.ring_halo_exchange_ref(blocks), 10),
                           ("kernel", lambda: cuda_kernels.ring_halo_exchange(blocks), 50),
                           ("library", lambda: (torch.roll(stacked, 1, 0),
                                                torch.roll(stacked, -1, 0)), 50),
                           ("kernel_again", lambda: cuda_kernels.ring_halo_exchange(blocks), 50),
                           ("plain_again", lambda: cuda_kernels.ring_halo_exchange_ref(blocks),
                            10)):
        t[name] = time_ms(fn, reps)
    nbytes = 3 * stacked.numel() * 4          # each block read once, written twice
    bound = bound_ms(nbytes, 0)
    phase(16, f"{RING} S={SHARDS} ({stacked.shape[1]} x {stacked.shape[2]} floats per shard): "
              f"kernel {t['kernel']:.4f} ms (again {t['kernel_again']:.4f}), plain "
              f"{t['plain']:.4f} ms (again {t['plain_again']:.4f}), two torch.roll "
              f"{t['library']:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
              f"{nbytes / 1e6:.1f} MB), {bound[0] / t['kernel'] * 100:.1f} % of the bound reached")

    # the sharded chunked steps, S=1 and S=4 in turns: ms per tick
    step_ms = {}
    for proposal in ("motion", "fastslam2"):
        cfg = config(proposal_mode=proposal)
        ms = Measurements(*tiled(pad_measurements(cfg, MEASUREMENTS, DEVICE)))
        rots, trans = torch.zeros(C, device=DEVICE), torch.full((C,), 0.4, device=DEVICE)
        gen_d = torch.Generator(device=DEVICE).manual_seed(16)
        draws = kernels.draw(gen_d, P, C, fs2=proposal == "fastslam2")
        for s in (1, SHARDS, SHARDS, 1):
            mesh = make_mesh(cfg, [DEVICE] * s)
            step = make_sharded_planes_chunked_step(cfg, mesh, C)
            holder = [shard_planes_state(init_planes_state(cfg, DEVICE), mesh, cfg)]

            def run():
                holder[0], _ = step(holder[0], rots, trans, ms, draws)
            step_ms.setdefault((proposal, s), []).append(time_ms(run, 5) / C)
        phase(16, f"sharded chunked step, {proposal}, P={P} L={L} M={M} C={C}: "
                  + ", ".join(f"S={s} {min(v):.4f} ms per tick (runs "
                              f"{' / '.join(f'{x:.4f}' for x in v)})"
                              for (p_, s), v in step_ms.items() if p_ == proposal))
    return (t["kernel"], t["plain"], t["library"]), bound


def onchip_bound_ms(nbytes, clock_mhz):
    """Least time of ``nbytes`` of shared-memory traffic on the card: 128
    bytes per clock on each SM at the sampled SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return nbytes / (SMEM_BYTES_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6) * 1e3


def phase17(gen, card):
    """The ceiling probes: each kernel against its plain version, the probes'
    entry points as their main path, times against bounds, and both probe
    commands as subprocesses."""
    import os

    import torch

    from fastslam_tpu_torch.core import cuda_kernels
    from fastslam_tpu_torch.probes import hbm_floor, vpu_roofline
    from fastslam_tpu_torch.utils.profiling import sm_clock_mhz

    randn = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE)
    bufs = [randn(L, P) for _ in range(6)] + [randn(1, P)]
    a, b, c = randn(L, P), randn(L, P), randn(L, P)
    errs = {}
    for name, got, want in (
        ("hbm_copy", lambda: cuda_kernels.hbm_copy(bufs),
         lambda: cuda_kernels.hbm_copy_ref(bufs)),
        ("mul_add", lambda: [cuda_kernels.mul_add(a, b, c, PROBE_PASSES, PROBE_TILE)],
         lambda: [cuda_kernels.mul_add_ref(a, b, c, PROBE_PASSES, PROBE_TILE)]),
        ("fma_chain", lambda: [cuda_kernels.fma_chain(a, PROBE_PASSES)],
         lambda: [cuda_kernels.fma_chain_ref(a, PROBE_PASSES)]),
    ):
        g = got()
        torch.cuda.synchronize()
        w = want()
        err = max(float((x - y).abs().max()) for x, y in zip(g, w))
        off = sum(int((x != y).sum()) for x, y in zip(g, w))
        if name == "fma_chain":
            rel = max(float(((x - y).abs() / y.abs()).max()) for x, y in zip(g, w))
            if not rel <= FMA_RTOL:
                raise AssertionError(f"fma_chain: max rel err {rel:.3e} > {FMA_RTOL}")
            detail = f"max rel err {rel:.3e} (rtol {FMA_RTOL}), {off} of {a.numel()} off"
        else:
            if off or not all(torch.equal(x, y) for x, y in zip(g, w)):
                raise AssertionError(f"{name}: {off} values differ from the plain version")
            detail = "equal exactly"
        errs[name] = err
        phase(17, f"{name} vs plain at L={L} P={P}: {detail}, max abs err {err:.3e}")

    clocks = [sm_clock_mhz()]
    k_copy, k_vpu = 20, 10
    runs, launches, wall = zeroed_run(lambda: (
        hbm_floor.run(P, L, k_copy, DEVICE),
        vpu_roofline.run(P, L, PROBE_PASSES, k_vpu, PROBE_TILE, DEVICE)))
    clocks.append(sm_clock_mhz())
    expected = {k: 0 for k in launches} | {"hbm_copy": 2 * k_copy, "mul_add": 4 * k_vpu,
                                           "fma_chain": 4 * k_vpu}
    if launches != expected:
        raise AssertionError(f"probe launches {launches}, expected {expected}")
    copy, vpu = runs
    phase(17, f"probes' main path (hbm_floor.run k={k_copy}, vpu_roofline.run k={k_vpu}): "
              f"wall {wall:.2f} s, launches {launches}")

    # plain, library, plain for the copy; the plain probes once
    t = {"plain_copy": time_ms(lambda: cuda_kernels.hbm_copy_ref(bufs), 10),
         "library_copy": time_ms(lambda: torch._foreach_add(bufs, 1.0), 20),
         "plain_copy_again": time_ms(lambda: cuda_kernels.hbm_copy_ref(bufs), 10),
         "plain_mul_add": time_ms(lambda: cuda_kernels.mul_add_ref(
             a, b, c, PROBE_PASSES, PROBE_TILE), 2),
         "plain_fma": time_ms(lambda: cuda_kernels.fma_chain_ref(a, PROBE_PASSES), 1)}
    clocks.append(sm_clock_mhz())
    clock = min(c for c in clocks if c)
    n = L * P
    copy_bytes = hbm_floor.copy_bytes(P, L)
    smem_bytes = PROBE_PASSES * 4 * 4 * n        # 3 reads, 1 write per element and pass
    fma_flops = 2 * 8 * PROBE_PASSES * n
    bounds = {"hbm_copy": bound_ms(copy_bytes, 0),
              "mul_add": bound_ms(4 * 4 * n, (2 * PROBE_PASSES + 1) * n),
              "fma_chain": bound_ms(2 * 4 * n, fma_flops)}
    onchip = onchip_bound_ms(smem_bytes, clock)
    times = {"hbm_copy": (copy["copy_ms"], t["plain_copy"], t["library_copy"]),
             "mul_add": (vpu["mul_add_ms"], t["plain_mul_add"], None),
             "fma_chain": (vpu["fma_chain_ms"], t["plain_fma"], None)}
    tag = f"({card}, SM clock {'/'.join(f'{c:.0f}' for c in clocks)} MHz)"
    phase(17, f"hbm_copy: {copy['copy_ms']:.4f} ms per call, {copy['gbps']:.1f} GB/s "
              f"against {PEAK_BYTES_PER_S / 1e9:.0f} GB/s ({bounds['hbm_copy'][0] / copy['copy_ms'] * 100:.1f} % "
              f"of the {bounds['hbm_copy'][0]:.4f} ms bound, {copy_bytes / 1e6:.1f} MB); "
              f"plain {t['plain_copy']:.4f} ms (again {t['plain_copy_again']:.4f}), "
              f"torch._foreach_add {t['library_copy']:.4f} ms {tag}")
    phase(17, f"mul_add: {vpu['mul_add_ms']:.4f} ms per call, shared memory "
              f"{smem_bytes / vpu['mul_add_ms'] / 1e9:.1f} TB/s against "
              f"{smem_bytes / onchip / 1e9:.1f} TB/s at {clock:.0f} MHz ({onchip / vpu['mul_add_ms'] * 100:.1f} % "
              f"of the {onchip:.4f} ms on-chip bound, {smem_bytes / 1e9:.1f} GB); "
              f"bare-function bound {bounds['mul_add'][0]:.4f} ms ({bounds['mul_add'][1]}); "
              f"plain {t['plain_mul_add']:.2f} ms {tag}")
    phase(17, f"fma_chain: {vpu['fma_chain_ms']:.4f} ms per call, "
              f"{fma_flops / vpu['fma_chain_ms'] / 1e9:.2f} TFLOP/s against "
              f"{PEAK_F32_OPS_PER_S / 1e12:.0f} ({bounds['fma_chain'][0] / vpu['fma_chain_ms'] * 100:.1f} % "
              f"of the {bounds['fma_chain'][0]:.4f} ms bound); plain {t['plain_fma']:.2f} ms {tag}")

    root = os.path.dirname(os.path.abspath(__file__))
    for module, args in (("hbm_floor", ["--k", "5"]),
                         ("vpu_roofline", ["--k", "3", "--passes", "64"])):
        proc = subprocess.run([sys.executable, "-m", f"fastslam_tpu_torch.probes.{module}",
                               *args], cwd=root, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode:
            raise AssertionError(f"probes.{module} exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        if out["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"{module} ran on {out['device']}")
        phase(17, f"python -m fastslam_tpu_torch.probes.{module} {' '.join(args)}: "
                  f"{json.dumps(out)}")
    return errs, launches, times, bounds, onchip


def phase18(log, online_est, online_wall):
    """The fused online loop of phase 12 with every production hook on."""
    import os
    import shutil

    import numpy as np
    import torch

    from fastslam_tpu_torch.app.runner import run_driver
    from fastslam_tpu_torch.drivers.replay import ReplayDriver
    from fastslam_tpu_torch.io.checkpoint import load_checkpoint
    from fastslam_tpu_torch.io.serializer import deserialize_tick

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                           "chip_smoke_hooks")
    shutil.rmtree(out_dir, ignore_errors=True)
    snap, metrics, ckpt = (os.path.join(out_dir, f)
                           for f in ("fast_slam.json", "metrics.jsonl", "ck.npz"))
    try:
        hist, launches, wall = zeroed_run(lambda: run_driver(
            ReplayDriver(log), adaptive_config(), rng=0, device=DEVICE,
            serialize_path=snap, serialize_every=10, metrics_path=metrics,
            checkpoint_path=ckpt, checkpoint_every=150, health=True))
        check_fused("hooked online loop", log, hist, launches, 0.05)
        est = np.asarray(hist.est_poses)
        if not np.array_equal(est, online_est):
            raise AssertionError(f"hooked online loop: estimates differ from phase 12's "
                                 f"by {np.abs(est - online_est).max():.3e}")
        view = deserialize_tick(snap)
        if view is None or not 0 < len(view["particles"]) <= 500 or not view["landmarks"]:
            raise AssertionError(f"snapshot {snap}: {view and len(view['particles'])} "
                                 f"particles, {view and len(view['landmarks'])} landmarks")
        records = [json.loads(line) for line in open(metrics)]
        ticks = sum(r["kind"] == "tick" for r in records)
        health = [r for r in records if r["kind"] == "health"]
        if ticks != 300 or any("nan_or_inf_state" in r["issues"] for r in health):
            raise AssertionError(f"metrics: {ticks} tick records, health {health[:3]}")
        size_mb = os.path.getsize(ckpt) / 1e6
        state, meta = load_checkpoint(ckpt, DEVICE)
        shapes = {"poses": (P, 3), "log_weights": (P,), "lm_mean": (P, L, 2),
                  "lm_cov": (P, L, 4), "lm_count": (P,)}
        got = {k: tuple(getattr(state, k).shape) for k in shapes}
        finite = all(bool(torch.isfinite(getattr(state, k).float()).all()) for k in shapes)
        if meta["iteration"] != 150 or got != shapes or not finite or meta["generator"] is None:
            raise AssertionError(f"checkpoint: iteration {meta['iteration']}, shapes {got}, "
                                 f"finite {finite}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    spent = hist.stage_seconds
    issues = sorted({i for r in health for i in r["issues"]})
    phase(18, f"run_driver with every hook on, fused tick, 300 ticks P={P} L={L}: the same "
              f"300 estimates as phase 12's fused run bit for bit; wall {wall:.2f} s = "
              f"{wall / 300 * 1e3:.2f} ms per tick (phase 12 without hooks "
              f"{online_wall / 300 * 1e3:.2f} ms); hooks' host seconds: "
              + ", ".join(f"{k} {spent[k]:.3f}" for k in ("health", "metrics", "serialize",
                                                          "checkpoint"))
              + f" (30 snapshots, 1 checkpoint of {size_mb:.1f} MB); "
              f"{len(view['particles'])} particles and {len(view['landmarks'])} landmarks "
              f"in the last snapshot; health issues seen: {issues or 'none'}")
    return launches


def phase19(log):
    """The reference API facades on the card."""
    import numpy as np
    import torch

    from fastslam_tpu_torch import api
    from fastslam_tpu_torch.app.runner import scan_points
    from fastslam_tpu_torch.config import DEFAULT_CONFIG
    from fastslam_tpu_torch.models import Measurement
    from fastslam_tpu_torch.proposal.icp import icp

    pts, valid = scan_points(log)
    src, tgt = pts[100][valid[100]], pts[101][valid[101]]

    def run():
        t0 = time.perf_counter()
        slam = api.FastSLAM2(config(), rng=0, device=DEVICE)
        poses = [slam.iterate(0.0, 0.4, [Measurement(d, b) for d, b in MEASUREMENTS])
                 for _ in range(10)]
        tick_s = (time.perf_counter() - t0) / 10   # each iterate ends in a host copy
        return poses, api.ICP.get_transformation(src, tgt, device=DEVICE), tick_s

    (poses, (rot, trans), tick_s), launches, _ = zeroed_run(run)
    want = {k: 0 for k in launches} | {"fused_update_planes": 10, ICP: launches[ICP]}
    if launches != want or not launches[ICP]:
        raise AssertionError(f"api launches {launches}, expected {want} and ICP > 0")
    if not np.isfinite(poses).all():
        raise AssertionError(f"api.FastSLAM2 poses not finite: {poses[-1]}")
    ones = lambda a: torch.ones(len(a), dtype=torch.bool, device=DEVICE)
    res = icp(torch.from_numpy(src).to(DEVICE), torch.from_numpy(tgt).to(DEVICE), ones(src),
              ones(tgt), DEFAULT_CONFIG.replace(icp_max_iterations=100, icp_tolerance=1e-5))
    if not (np.array_equal(rot, res.rotation.cpu().numpy())
            and np.array_equal(trans, res.translation.cpu().numpy())):
        raise AssertionError("api.ICP differs from proposal/icp.icp on the same pair")
    phase(19, f"api.FastSLAM2 P={P} L={L} production, 10 ticks of bench.py's {M} "
              f"measurements: last pose {tuple(round(v, 4) for v in poses[-1])}, "
              f"{tick_s * 1e3:.2f} ms per tick (host clock, the first tick included); "
              f"api.ICP on scans 100 -> 101 equals proposal.icp.icp bit for bit "
              f"(theta {float(np.arctan2(rot[1, 0], rot[0, 0])):.6f} rad); launches {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    phase(0, f"torch {torch.__version__} cuda {torch.version.cuda}, "
             f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.core import _build
    from fastslam_tpu_torch.core.state import pad_measurements
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld

    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    report = _build.library_path().with_suffix(".log")
    regs = (ptxas_summary(report.read_text()) if report.exists()
            else ["(cached build, no ptxas report)"])
    phase(1, f"built {', '.join(p.name for p in _build.sources())} in {build_s:.1f} s")
    for line in regs:
        phase(1, f"ptxas: {line}")
    from fastslam_tpu_torch.core import cuda_kernels

    tile, lanes = cuda_kernels.fs2_launch_geometry(L, M)
    phase(1, f"fs2 kernels at L={L}, M={M}: tiles of {tile} particles x {lanes} lanes, "
             f"{cuda_kernels.fs2_shared_bytes(L, M, tile)} B of dynamic shared memory per block")
    for kernel in ("per-tick", "chunked"):
        instance = "fused_update_planes_multi_kernel" if kernel == "chunked" \
            else "fused_update_planes_kernel"
        for parity in (False, True):
            tile, lanes = cuda_kernels.motion_launch_geometry(L, M, parity)
            ptxas = [line for line in regs if line.startswith(f"{instance}<{int(parity)}>")]
            phase(1, f"{kernel} motion kernel at L={L}, M={M}, "
                     f"{'parity' if parity else 'production'}: tiles of {tile} particles x "
                     f"{lanes} lanes, {cuda_kernels.motion_shared_bytes(L, M, tile, parity)} B "
                     f"of dynamic shared memory per block; ptxas {'; '.join(ptxas) or 'n/a'}")
    p2, smem, in_scratch = cuda_kernels.icp_fused_layout(180, 180)
    phase(1, f"fused ICP kernel at 180 x 180 points: {cuda_kernels.ICP_THREADS} threads x "
             f"{cuda_kernels.ICP_LANES} lanes per pair, sums padded to {p2}, {smem} B of dynamic "
             f"shared memory per block{' (per-point arrays in scratch)' if in_scratch else ''}")

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    ms = pad_measurements(FastSLAMConfig(max_measurements=M), MEASUREMENTS, DEVICE)
    errs = {"fused_update_planes": phase2(gen, ms),
            "fused_update_planes_multi": phase3(gen, ms)}
    log = record_log(SimWorld(seed=3), num_ticks=300)
    paths = {"motion_replay": phase4(log)}   # launches of each main path's run
    errs["fused_fs2_planes"] = phase5(gen, ms)
    errs["fused_fs2_planes_multi"] = phase6(gen, ms)
    paths["fs2_replay"], fs2_ate = replay_main_path(
        7, log, config(proposal_mode="fastslam2"), FS2, 0.15)
    phase8()
    batch = replay_icp_batch(log)
    times, bounds = phase9(gen, ms, batch)
    phase10_sin_cos(gen)
    errs[ICP], errs[FUSED_ICP] = phase10(batch)
    paths["adaptive_replay"] = phase11(log, fs2_ate)
    paths["online"], paths["online_fused"], online_est, online_wall = phase12(log, card)
    errs[RING] = phase13(gen)
    phase14()
    paths["sharded"] = phase15()
    ring_times, bounds[RING] = phase16(gen)
    times[RING] = ring_times
    probe_errs, paths["probes"], probe_times, probe_bounds, onchip = phase17(gen, card)
    errs.update(probe_errs)
    times.update(probe_times)
    bounds.update(probe_bounds)
    paths["hooked_online"] = phase18(log, online_est, online_wall)
    paths["api"] = phase19(log)
    paths["tracked_online"], paths["jderobot"] = phase20(log, card)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": sum(path[name] for path in paths.values()),
         "launches_by_path": {k: path[name] for k, path in paths.items()},
         "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": times[name][2]}
        | ({"onchip_bound_ms": onchip} if name == "mul_add" else {})
        for name, (src, replaces) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
