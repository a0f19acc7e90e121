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
    captured CUDA graph per tick (299), 300 fs2, 300 fused ICP and 300 of
    each resample launch (replays counted), ATE under 0.05 m, a second run
    bit for bit, and the same 300 estimates as the fused tick run eagerly
    on the card (no graph); ms per tick of each, with the card's name and power limit; the
    graph's device time per replay, its kernels per replay and its top
    kernels, and the cost of the resample decided on the device with no
    resample due and of the copies back into the static state that remain
    (poses and weights: the planes and counts are the state's own);
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
    iteration 150 with full shapes and finite arrays, its five members
    deflated on the card (``deflate_fixed``), no ``nan_or_inf_state``; ms
    per tick with and without hooks and the seconds each hook took; then
    each of the checkpoint's five members through ``deflate_fixed`` and
    through ``deflate_fixed_ref`` on its CPU copy, stream and length, CRC
    and row-match bytes equal byte for byte, the kernel's ms (CUDA events),
    the plain version's and the bound (the member read and its stream
    written);
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
    with ms per tick;
21. the pose-graph backend on the card.  (a) BASELINE config #5 at full
    scale through ``eval.backend_1m.run`` (the world built and aligned once):
    the serpentine survey world (``backend/survey.py``) with 1.1M
    landmarks and K=1024 keyframes, consensus alignment, the graph (2^21
    landmark slots, 2^23 factor slots) with the host seconds of each stage;
    ``optimize_sharded``, 4 GN iterations at damping 1e-3, on a map mesh of
    4 shards of the card (exactly 4 segment_sum launches per shard per
    iteration), held to ``scripts/bench_backend_1m.py``'s assertions
    (``eval.backend_1m.check``: no factor dropped, landmarks within 3 % of
    1.1M, error down, gauge-aligned keyframe error under 0.6x and within
    0.05 + 0.25x of the committed ``eval_results/backend_1m.json``); the
    optimization again bit for bit, then on 1
    shard (poses within 1e-4, landmarks within 1e-3 of S=4); ms per
    iteration by CUDA events split into the Schur reduction, its cross term,
    the Cholesky solve, back-substitution and the host error, and the peak
    device memory; the dry run's backend block on 4 shards; the segment-sum
    kernel against its plain version bit for bit at each of shard 0's four
    sums of an iteration, timed beside its plain version, ``index_add_`` in
    float64 and in float32, and its bound (the kernels line gives each
    call's under ``calls``).  (b) ``smooth_trajectory`` on phase 12's fused
    estimates, greedy and tracked, each twice bit for bit, keyframe error
    before and after.  (c) ``merge_sessions`` on two maps of 4,096 landmarks against
    the same call on the CPU: the transform within 1e-4, the same matches
    and masks, the ICP search's launches;
22. the 2-D particle x map mesh: the blocks step on a 4 x 2 mesh of the card
    at P=100,000, L=64, M=16 (motion parity, motion production with the halo
    resampler, fs2; 3 ticks each, forced resamples), one launch of the
    per-tick kernel per particle row per tick (4), each mode bit for bit
    the same at S=1 and on the single-device step; ms per tick of the blocks
    step (motion, fs2) on the 4 x 2 mesh beside the 1-D mesh at S=1 and S=4
    and the single-device step, in turns;
23. the engine across processes: the script starts itself twice
    (``--worker <rank> <port> <dir>``), two processes on the card joined by
    gloo, 2 shards each of a 4-shard mesh, P=100,000: the three blocks modes
    of phase 22, 3 per-tick planes fs2 ticks and one chunk of C=16 (motion,
    fs2), forced resamples through the whole-state gather and the halo
    resampler; each process launches its kernel once per local shard per
    tick or chunk; both processes' estimates and gathered states bit for
    bit one process at S=4; ms per tick of each process (blocks step with no
    resample, with the whole-state gather, with the halo resampler; the
    chunked step), the host ms of it in collectives and the bytes received
    through the group.  Then the ring resampler across the two processes:
    on healthy weights (the halo path) and collapsed ones (the fallback),
    with their launches counted, it and the halo resampler equal
    ``resample_state`` bit for bit, with one launch of the exchange
    kernel's cross-process form per process per call; 20 consecutive
    exchanges on new blocks each equal the plain exchange (``ppermute``
    over gloo) bit for bit, and 20 more back to back with no gloo call
    between them; ms per call of the kernel and the plain exchange, and of
    the ring and the halo resampler, in turns; how often each process's
    wait (a) found its words already set, its longest wait there, and its
    device ms per call in wait (a), the copy and wait (c);
24. the sharded checkpoint: both processes save their blocks and planes
    states of phase 23 with ``save_sharded_checkpoint`` and load them into
    fresh templates, bit for bit with the generator; seconds to save and to
    load, bytes on disk.  A worker that fails fails the run;
25. the accuracy matrix's scale section on the card
    (``fastslam_tpu_torch.eval.suite.section_scale``) at seed 3, rng 0, on
    ``make_log``'s drive (start (-0.35, 0, 0), range noise 0.005): all 13
    rows, P up to 100,000, L=64, each ATE beside the JAX suite's seed-3
    value in ``eval_results/scale.json`` and the kernels each row launched;
    every clean production row below the oracle row, the fs2 + adaptive row
    under slip below the slip oracle row (the motion-only slip row is
    printed, not gated), and ``production chunked C=16 (N=100k, H100)`` run
    twice more with the same estimates bit for bit; the phase's wall time
    and launches (the ``accuracy`` path of the kernels line);
26. the ring across four processes, one shard each, so that every
    neighbour is another process: ``probes/check_ring_resample.py``'s
    ``run`` at P=100,000, L=64 (four gloo processes on the card): the ring
    resampler against ``resample_state`` on both weight profiles, bit for
    bit, one launch of the cross-process kernel per process per call
    (launches counted over the calls); 20 exchanges against the plain
    exchange bit for bit, and 20 back to back; ms per exchange and per
    resample of the kernel and of gloo in turns, beside phase 23's; the
    waits, as in phase 23;
27. the card against the CPU (``probes.check_parity``, the counterpart of
    ``scripts/check_pallas_parity.py``), each check from the same draws:
    the per-tick motion kernel in 3 parity-mode blocks steps at P=800,
    L=64, M=16 (counts equal; poses and the returned pose 1e-5, means and
    covariances 5e-4, log-weights 5e-3), the per-tick fs2 kernel in 3
    planes steps against the CPU's blocks steps at P=1,024 (under 1 % count
    flips; on the rest, the 99th percentile under poses 5e-5, means and
    covariances 5e-4, log-weights 5e-2, under 1 % past a bar); both at
    P=100,000, fs2 tick by tick from the CPU's state (the kernel's tick
    before the resample); both chunked kernels, one chunk of C=16 at P=800 and
    1,024 under the production bars, and the motion chunk's per-tick
    estimates; the phase's seconds;
28. the slip forensics (``eval.diagnose_slip``): the online fs2 + ICP +
    adaptive loop at seed 3 under slip, N=100, twice bit for bit, every
    key finite, its table by windows of 25 ticks; the corridor JdeRobot
    trace's motion-only slip row (``replay_chunked`` at N=100,000, C=8,
    rng 0) and its oracle tick by tick, every key finite, the engine run
    again bit for bit, the two odometry sequences parting only where their
    command pairing does, the table; the phase's seconds;
29. ``io.make_jderobot_trace``: both committed traces of
    ``data/jderobot/`` recorded again through ``SimHAL``, byte for byte;
    the phase's seconds;
30. ``probes.step`` (the counterpart of ``scripts/bench_step.py``) at
    P=100,000, L=64, M=16: K=50 steps captured in one CUDA graph (each
    deciding its resample on the device) for ``planes``,
    ``planes+fusedonly``, ``chunked16+prod``, ``chunked16+fs2+prod``,
    ``planes+frontend`` and ``scan``; each graph's K steps equal K eager
    steps (the host deciding) bit for bit, from the same state and draws,
    and again after the timed repetitions; ms per tick of the graph and
    the eager form, the capture's seconds;
31. ``probes.compare`` (``scripts/bench_compare.py``): the blocks step with
    the per-tick kernel and with the plain measurement loop, 20 steps
    after 3 warm ones; rows 1–4 against their plain versions on one shared
    state, every pair 0 apart; the device-decided resample's staircase and
    gather (``csrc/resample.cu``) against their plain versions at P=100,000,
    L=64, 0 apart, each timed with a resample due and not due (20 calls in
    one CUDA graph) beside its bound, the plain versions and the parent's
    ATen path (``torch.cummax`` and ``index_select``);
32. ``probes.e2e_attribution``: the K-sweep (16, 64, 192) of frontend +
    planes step in one graph each and its linear fit, the frontend and the
    filter alone at K=192, and ``SLAMRunner.tick_fused`` over the same 192
    scans (host-clock median and 90th percentile, device ms per replay);
33. ``probes.collective_bytes`` on 8 shards of the card, 8,192 particles
    each: per resampler (whole-state gather, halo, ring) the ops and bytes
    of a tick without a resample and of the resample; the whole-state
    gather's bytes equal P (3 + 1 + 6 L + 1) 4 from the shapes, and the
    ring resampler launched the exchange kernel;
34. ``probes.scaling``: the blocks and the chunked sharded steps at 1, 2,
    4 and 8 shards of the card, 12,500 particles each, each S's first step
    equal to one shard's bit for bit; ms per tick and the efficiency
    against S = 1;
35. the benchmark command, ``fastslam_tpu_torch.bench.main`` at
    ``bench.py``'s geometry (P=100,000, L=64, M=16, C=16, 768 ticks per
    chunked window, 192 scans end to end) with its windows, reps and
    budgets: its one JSON line printed, every key of ``bench.py``'s line
    there with ``device``, ``power_limit_w`` and ``launches``, every number
    finite and positive, every window's graph held to its eager run bit
    for bit (the command raises otherwise), and launches of rows 1, 2 and 4
    (the e2e loop's per-tick motion kernel, the chunked motion and fs2
    kernels).  Each of phases 30–35 counts its own launches (the
    ``step``, ``compare``, ``e2e_attribution``,
    ``collective_bytes``, ``scaling`` and ``bench`` paths of the kernels
    line).

Any failure raises.  The card's name and power limit come on the line
before the kernels' JSON summary (launches of each main path's first run
and their sum; the bound from this run's shapes and the landmark slots the
timed calls read and write, against the H100's published peaks), which is
the line before the last; the last line is ``{"ok": true, "device":
{...}}``.
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
    # the same TPU kernel across processes: its barrier and remote writes
    "ring_halo_exchange_peers": ("fastslam_tpu_torch/csrc/ring_halo.cu",
                                 "fastslam_tpu/parallel/ring_resample.py:106"),
    "hbm_copy": ("fastslam_tpu_torch/csrc/probes.cu", "scripts/bench_hbm_floor.py:47"),
    "mul_add": ("fastslam_tpu_torch/csrc/probes.cu", "scripts/bench_vpu_roofline.py:112"),
    "fma_chain": ("fastslam_tpu_torch/csrc/probes.cu", "scripts/bench_vpu_roofline.py:115"),
    # port-only: no Pallas kernel; it replaces XLA's float scatter-adds of
    # fastslam_tpu/backend/pose_graph.py:315-419
    "segment_sum": ("fastslam_tpu_torch/csrc/segment_sum.cu",
                    "fastslam_tpu/backend/pose_graph.py:315"),
    # port-only: no Pallas kernel; they replace the resample under lax.cond
    # of fastslam_tpu/core/kernels.py:_normalize_and_resample (its staircase
    # and its gather)
    "resample_staircase": ("fastslam_tpu_torch/csrc/resample.cu",
                           "fastslam_tpu/core/kernels.py:grid_staircase_indices"),
    "resample_gather": ("fastslam_tpu_torch/csrc/resample.cu",
                        "fastslam_tpu/core/kernels.py:resample_planes_state"),
    # port-only: no Pallas kernel; it replaces the host zlib of the
    # np.savez_compressed in the checkpoint writer
    "deflate_fixed": ("fastslam_tpu_torch/csrc/deflate.cu",
                      "fastslam_tpu/io/checkpoint.py:save_checkpoint"),
}
MOTION = ("fused_update_planes", "fused_update_planes_multi")
FS2 = ("fused_fs2_planes", "fused_fs2_planes_multi")
ICP = "icp_correspondences"
FUSED_ICP = "icp_point_to_line"
RING = "ring_halo_exchange"
PEERS = "ring_halo_exchange_peers"
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
# masked by has_prev) and the device-decided resample's two calls, replays
# counted
ONLINE_FUSED_LAUNCHES = {"fused_fs2_planes": 300, "icp_point_to_line": 300,
                         "resample_staircase": 300, "resample_gather": 300}
# with the hooks, the one checkpoint's encoder: once per member of the blocks
# state, each at least io/checkpoint.ENCODER_MIN_BYTES at P
HOOKED_FUSED_LAUNCHES = {**ONLINE_FUSED_LAUNCHES, "deflate_fixed": 5}
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
                                      "fma_chain_kernel", "segment_sum_kernel",
                                      "staircase_tile_sums", "staircase_counts",
                                      "staircase_ancestors", "gather_kernel")
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
    """``replay_chunked`` twice, the launches of the first run counted;
    the first run must launch only ``kernels_run`` (18 chunked,
    12 per-tick), reach ATE < ``ate_bar``, and the second must repeat its
    estimates bit for bit.  Returns (launches, ATE)."""
    import numpy as np
    import torch

    from fastslam_tpu_torch.app.runner import replay_chunked
    from fastslam_tpu_torch.core import cuda_kernels

    t0 = time.perf_counter()
    with cuda_kernels.counted() as counted:
        hist = replay_chunked(log, cfg, chunk_size=C, rng=0, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict.fromkeys(cuda_kernels.LAUNCHES, 0) | counted
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
    from fastslam_tpu_torch.core.cuda_kernels import icp

    saved = icp.ICP_THREADS, icp.ICP_LANES
    icp.ICP_THREADS, icp.ICP_LANES = geometry
    try:
        return run()
    finally:
        icp.ICP_THREADS, icp.ICP_LANES = saved


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
    from fastslam_tpu_torch.core.cuda_kernels import filter

    saved = filter.FS2_TILE, filter.FS2_LANES
    filter.FS2_TILE, filter.FS2_LANES = geometry
    try:
        return run()
    finally:
        filter.FS2_TILE, filter.FS2_LANES = saved


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
    from fastslam_tpu_torch.core.cuda_kernels import filter

    saved = filter.MOTION_TILE, filter.MOTION_LANES
    filter.MOTION_TILE, filter.MOTION_LANES = geometry
    try:
        return run()
    finally:
        filter.MOTION_TILE, filter.MOTION_LANES = saved


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


def counted_run(run):
    """``run()`` with its launches counted; returns its result, the
    launches of every kernel, and the wall time."""
    import torch

    from fastslam_tpu_torch.core import cuda_kernels

    t0 = time.perf_counter()
    with cuda_kernels.counted() as launches:
        out = run()
    torch.cuda.synchronize()
    return out, dict.fromkeys(cuda_kernels.LAUNCHES, 0) | launches, time.perf_counter() - t0


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
    hist, launches, wall = counted_run(replay)
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
    slipped, slip_launches, slip_wall = counted_run(lambda: replay(SLIP))
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
    """``run_driver`` over ``log`` on the card, its launches counted."""
    from fastslam_tpu_torch.app.runner import run_driver
    from fastslam_tpu_torch.drivers.replay import ReplayDriver

    return counted_run(lambda: run_driver(ReplayDriver(log), cfg, rng=0, device=DEVICE, **kw))


def check_fused(tag, log, hist, launches, ate_bar, expected=ONLINE_FUSED_LAUNCHES):
    """One graph replay per tick after the eager first one, the fused
    path's launches (``expected``), finite estimates under ``ate_bar``."""
    check_icp_launches(tag, launches, expected)
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
    decided on the device (the kernels of ``csrc/resample.cu``, which
    return at once) beside the host branch (no resample due), and of the
    copies back into the static state that remain: the planes and counts
    the step returns are the state's own, and a copy onto itself is
    skipped."""
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
    pairs = [(getattr(target, k), getattr(state, k)) for k in ("poses", "log_weights")]
    copy_ms = time_ms(lambda: [d.copy_(x) for d, x in pairs], 20)
    state_mb = sum(v.numel() * v.element_size() for _, v in pairs) / 1e6
    phase(12, f"fused tick's graph on {card}: {replay_ms:.4f} ms of device time per replay "
              f"(CUDA events), {sum(c for _, _, c in events):.0f} kernels and copies per replay "
              f"busy {busy:.4f} ms under torch.profiler; top: "
              + "; ".join(f"{k[:48]} {t:.4f} ms x{c:.0f}" for k, t, c in top))
    phase(12, f"resample decided on the device at P={P} L={L} (no resample due): "
              f"{device_ms:.4f} ms against the host branch's {host_ms:.4f} ms "
              f"(+{device_ms - host_ms:.4f} ms of eager calls, paced by the host's launches of "
              f"kernels that return at once: phase 31 times them in a graph); the copies "
              f"back of poses and weights ({state_mb:.1f} MB) {copy_ms:.4f} ms")
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


# phase 21: BASELINE config #5 (tests/test_backend_scale.py:157-215) at full
# scale (fastslam_tpu_torch/probes/segment_sum_turns.py builds it), cut to 4
# GN iterations as its evidence run (eval_results/backend_1m.json)
BACKEND_ITERS, BACKEND_DAMPING = 4, 1e-3
BACKEND_SUMS = 4        # segment sums per shard per GN iteration (sparse path)
MERGE_LANDMARKS = 4096  # per map in (c): the ICP search tiles its targets
MERGE_TOL = 1e-4       # (c) card vs CPU


def segment_sum_measure(inputs):
    """Each of the four sums: kernel against its plain version bit for bit;
    then per call the kernel's and two library calls' device times (20
    calls in a replayed CUDA graph: ``replay_ms``), the kernel's time per
    eager call and the plain version's (CUDA events), and the bound: the
    values and order entries of the segments' entries and the offsets read
    once (4 bytes each), the float64 sums written once (8 bytes each), over
    3.35 TB/s (one add per value: the bytes bound it).  The library calls: ``index_add_`` of the float32
    values (another precision, float32 atomics) and ``index_add_`` of
    ``values.double()`` (the same float64 function, its atomics in an order
    that varies), each into a ``torch.zeros``; the max difference of each
    from the plain sums."""
    import torch

    from fastslam_tpu_torch.core import cuda_kernels
    from fastslam_tpu_torch.probes.segment_sum_turns import replay_ms

    rows = {}
    for name, values, layout in inputs:
        got = cuda_kernels.segment_sum(values, layout)
        want = cuda_kernels.segment_sum_ref(values, layout)
        if not torch.equal(got, want):
            raise AssertionError(f"segment_sum {name}: {int((got != want).sum())} of "
                                 f"{want.numel()} sums differ from the plain version")
        c, s = values.shape[0], layout.num_segments
        entries = int(layout.offsets[-1])
        key = torch.full((values.shape[1],), s, dtype=torch.int64, device=DEVICE)
        key[layout.perm[:entries].long()] = torch.repeat_interleave(
            torch.arange(s, device=DEVICE), (layout.offsets[1:] - layout.offsets[:-1]).long(),
            output_size=entries)
        library = lambda: torch.zeros((c, s + 1), device=DEVICE).index_add_(1, key, values)
        library64 = lambda: torch.zeros((c, s + 1), dtype=torch.float64,
                                        device=DEVICE).index_add_(1, key, values.double())
        lib_err = lambda fn: float((fn()[:, :s] - want).abs().max()) if entries else 0.0
        nbytes = 4 * (c * entries + entries + s + 1) + 8 * c * s
        kernel = lambda: cuda_kernels.segment_sum(values, layout)
        rows[name] = {
            "ms": replay_ms(kernel, 20), "eager_ms": time_ms(kernel, 20),
            "plain_ms": time_ms(lambda: cuda_kernels.segment_sum_ref(values, layout), 3),
            "library_ms": replay_ms(library64, 20), "library_f32_ms": replay_ms(library, 20),
            "bound": bound_ms(nbytes, c * entries),
            "columns": c, "segments": s, "entries": entries,
            "long_segments": int(layout.long[0]),
            "library_err": lib_err(library64), "library_f32_err": lib_err(library)}
    return rows


def phase21_config5(card):
    """(a) BASELINE config #5 through ``eval.backend_1m.run`` (the world
    built and aligned once), its 1.1M-landmark graph optimized on map meshes
    of 4 and 1 shards of the card."""
    import os

    import numpy as np
    import torch

    from fastslam_tpu_torch.backend import distributed
    from fastslam_tpu_torch.eval import backend_1m
    from fastslam_tpu_torch.parallel import dryrun
    from fastslam_tpu_torch.parallel.mesh import make_map_mesh
    from fastslam_tpu_torch.utils.profiling import EventMarks

    from fastslam_tpu_torch.probes.segment_sum_turns import (
        CONFIG5_KEYFRAMES, CONFIG5_LANDMARKS, config5_sums,
    )

    def want_launches(launches, shards):
        want = {k: 0 for k in launches}
        want["segment_sum"] = BACKEND_SUMS * shards * BACKEND_ITERS
        if launches != want:
            raise AssertionError(f"config #5 at S={shards}: launches {launches}, "
                                 f"expected {want}")

    def run(shards):
        marks = EventMarks(DEVICE)
        torch.cuda.reset_peak_memory_stats()
        out, launches, wall = counted_run(lambda: distributed.optimize_sharded(
            g, make_map_mesh([DEVICE] * shards), num_iters=BACKEND_ITERS,
            damping=BACKEND_DAMPING, marks=marks))
        want_launches(launches, shards)
        return out, launches, wall, marks.stage_ms(), torch.cuda.max_memory_allocated()

    state, marks = {}, EventMarks(DEVICE)
    out, launches, _ = counted_run(lambda: backend_1m.run(
        CONFIG5_LANDMARKS, k=CONFIG5_KEYFRAMES, iters=BACKEND_ITERS, shards=SHARDS,
        device=DEVICE, marks=marks, state=state))
    want_launches(launches, SHARDS)
    g, gt, poses, lms, err = (state[k] for k in ("graph", "gt", "poses", "landmarks", "err"))
    phase(21, f"config #5 graph (eval.backend_1m.run): {out['n_landmarks_built']} landmarks "
              f"({CONFIG5_LANDMARKS} placed), {out['n_factors']} factors, "
              f"K={CONFIG5_KEYFRAMES}, capacities {out['lm_capacity']} / "
              f"{out['factor_capacity']}, no factor dropped at {SHARDS} shards; host seconds: "
              f"world {out['world_gen_seconds']:.2f}, consensus align "
              f"{out['align_seconds']:.2f} ({out['align_pairs_registered']} pairs registered), "
              f"build {out['build_seconds']:.2f}")
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "eval_results", "backend_1m.json")) as f:
        broken = backend_1m.check(out, json.load(f))
    if broken:
        raise AssertionError(f"config #5: {'; '.join(broken)}")
    stages = marks.stage_ms()
    before = out["mean_keyframe_error_before_gauge_aligned_m"]
    after = out["mean_keyframe_error_after_gauge_aligned_m"]
    iter_ms = sum(stages.values()) / BACKEND_ITERS
    split = ", ".join(f"{k} {v / BACKEND_ITERS:.2f}" for k, v in stages.items())
    phase(21, f"optimize_sharded S={SHARDS} shards of {card}, {BACKEND_ITERS} GN iterations, "
              f"damping {BACKEND_DAMPING}: error {out['total_error_before']:.6e} -> {err:.6e}, "
              f"gauge-aligned keyframe error {before:.4f} -> {after:.4f} m (bar 0.6x; the "
              f"JAX artifact's within 0.05 + 0.25x); {iter_ms:.2f} ms per "
              f"iteration (CUDA events; per iteration: {split}; schur includes the psum and "
              f"the pose system, cross is the cross term); wall {out['optimize_seconds']:.2f} "
              f"s; {launches['segment_sum'] / BACKEND_ITERS:.0f} segment_sum launches per "
              f"iteration; peak device memory {out['peak_device_memory_gb']:.3f} GB")
    (p2, l2, e2), _, wall2, stages2, _ = run(SHARDS)
    if not (torch.equal(p2, poses) and torch.equal(l2, lms) and e2 == err):
        raise AssertionError("config #5: a second S=4 run differs")
    phase(21, f"a second S={SHARDS} run equals the first bit for bit: "
              f"{sum(stages2.values()) / BACKEND_ITERS:.2f} ms per iteration ("
              f"{', '.join(f'{k} {v / BACKEND_ITERS:.2f}' for k, v in stages2.items())}), "
              f"wall {wall2:.2f} s")
    (p1, l1, e1), _, wall1, stages1, peak1 = run(1)
    diff = p1 - poses         # headings near +-pi: compare them wrapped
    diff[:, 2] = torch.remainder(diff[:, 2] + np.pi, 2 * np.pi) - np.pi
    dp = float(diff.abs().max())
    dl = float((l1 - lms).abs().max())
    if not (bool((diff.abs() <= 1e-4 + 1e-4 * p1.abs()).all()) and dl <= 1e-3):
        raise AssertionError(f"config #5: S={SHARDS} vs S=1 poses {dp:.3e}, landmarks {dl:.3e}")
    phase(21, f"S=1: error {e1:.6e}, {sum(stages1.values()) / BACKEND_ITERS:.2f} ms per "
              f"iteration ({', '.join(f'{k} {v / BACKEND_ITERS:.2f}' for k, v in stages1.items())}),"
              f" wall {wall1:.2f} s, peak {peak1 / 1e9:.3f} GB; S={SHARDS} vs S=1: poses "
              f"{dp:.3e} (bar 1e-4), landmarks {dl:.3e} (bar 1e-3)")
    dry = dryrun.dryrun_backend(SHARDS, DEVICE)
    phase(21, f"dryrun_backend on {SHARDS} shards of the card: error {dry['err']:.6e}, "
              f"launches {dry['launches']}")
    rows = segment_sum_measure(config5_sums(g, SHARDS, DEVICE))
    for name, r in rows.items():
        phase(21, f"segment_sum {name} (shard 0 of {SHARDS}: {r['columns']} columns, "
                  f"{r['entries']} entries, {r['segments']} segments, {r['long_segments']} "
                  f"of them long): kernel {r['ms']:.4f} ms (eager calls {r['eager_ms']:.4f}), "
                  f"plain {r['plain_ms']:.4f} ms, "
                  f"index_add_ float64 {r['library_ms']:.4f} ms (max diff "
                  f"{r['library_err']:.3e}), float32 {r['library_f32_ms']:.4f} ms (max diff "
                  f"{r['library_f32_err']:.3e}), bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]}; {100 * r['bound'][0] / r['ms']:.1f} %); bit for bit the "
                  f"plain version")
    return launches, rows


def phase21_smooth(log, est):
    """(b) smooth_trajectory on the card, greedy and tracked, twice each."""
    import numpy as np

    from fastslam_tpu_torch.backend.integration import smooth_trajectory
    from fastslam_tpu_torch.config import FastSLAMConfig

    total = None
    for tracking in (False, True):
        runs = []
        for _ in range(2):
            out, launches, wall = counted_run(lambda: smooth_trajectory(
                log, est, FastSLAMConfig(), use_tracking=tracking, device=DEVICE))
            runs.append((out, launches, wall))
        (poses, ticks, info), launches, wall = runs[0]
        if not np.array_equal(runs[1][0][0], poses):
            raise AssertionError(f"smooth_trajectory (tracking {tracking}): a second run differs")
        if not np.isfinite(poses).all() or launches["segment_sum"] == 0:
            raise AssertionError(f"smooth_trajectory: finite {np.isfinite(poses).all()}, "
                                 f"launches {launches}")
        gt = log.gt_poses[ticks, :2]
        err = lambda p: float(np.linalg.norm(p[:, :2] - gt, axis=1).mean())
        phase(21, f"smooth_trajectory ({'tracked' if tracking else 'greedy'}) on phase 12's "
                  f"fused estimates, {len(ticks)} keyframes: mean keyframe error "
                  f"{err(est[ticks]):.4f} -> {err(poses):.4f} m, {info['num_landmarks']} "
                  f"landmarks, {info['num_factors']} factors, "
                  f"{info['reassociation_rounds']} re-association rounds; {wall:.2f} s "
                  f"(again {runs[1][2]:.2f} s, bit for bit); launches "
                  f"{ {k: v for k, v in launches.items() if v} }")
        total = launches if total is None else {k: total[k] + launches[k] for k in total}
    return total


def merge_maps(n=MERGE_LANDMARKS, seed=0, theta=0.004, tx=0.4, ty=-0.3, noise=0.02):
    """A ``tests/test_map_merge.py:make_maps``-style pair: n landmarks per
    map, 85 % shared, B's map in a frame offset by (theta, tx, ty), A's map
    in 2n slots so that B's own landmarks append."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n_shared = int(0.85 * n)
    side = 3.0 * np.sqrt(n)
    shared = rng.uniform(-side, side, (n_shared, 2))
    a_only = rng.uniform(-side, side, (n - n_shared, 2))
    b_only = rng.uniform(-side, side, (n - n_shared, 2))
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    b_world = np.concatenate([shared + rng.normal(0, noise, shared.shape), b_only])
    b_frame = (b_world - np.array([tx, ty])) @ rot
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)
    lm_a = np.concatenate([shared, a_only, np.zeros((n, 2))])
    valid_a = torch.arange(2 * n) < n
    return [f32(lm_a), valid_a, f32(b_frame), torch.ones(n, dtype=torch.bool)], rot


def phase21_merge():
    """(c) merge_sessions on the card against the CPU (plain path)."""
    import torch

    from fastslam_tpu_torch.backend.map_merge import merge_sessions

    args, rot = merge_maps()
    want_al, want_m, _ = merge_sessions(*args)
    (al, m, _), launches, wall = counted_run(
        lambda: merge_sessions(*(a.to(DEVICE) for a in args)))
    err = max(float((al.rotation.cpu() - want_al.rotation).abs().max()),
              float((al.translation.cpu() - want_al.translation).abs().max()))
    masks = all(torch.equal(getattr(m, f).cpu(), getattr(want_m, f))
                for f in ("valid", "matched_b", "appended_b", "dropped_b"))
    if err > MERGE_TOL or int(al.num_matched) != int(want_al.num_matched) or not masks \
            or launches[ICP] == 0:
        raise AssertionError(f"merge_sessions on the card vs cpu: transform {err:.3e}, matched "
                             f"{int(al.num_matched)} / {int(want_al.num_matched)}, masks equal "
                             f"{masks}, launches {launches}")
    truth = float(abs(al.rotation.cpu().numpy() - rot).max())
    phase(21, f"merge_sessions, {MERGE_LANDMARKS} landmarks per map, on the card: transform "
              f"within {err:.3e} of the CPU's (bar {MERGE_TOL}), {int(al.num_matched)} "
              f"matched, {int(m.matched_b.sum())} fused and {int(m.appended_b.sum())} appended "
              f"(masks equal), rotation {truth:.3e} from the truth; {wall:.3f} s, "
              f"{launches[ICP]} {ICP} launches")
    return launches


def phase21(log, est, card):
    """The pose-graph backend on the card: (a) BASELINE config #5, (b)
    trajectory smoothing, (c) the map merge.  Returns the backend path's
    launches (the first S=4 run, the first smoothing runs, the merge) and
    segment_sum's measurements."""
    launches, rows = phase21_config5(card)
    smooth = phase21_smooth(log, est)
    merge = phase21_merge()
    return {k: launches[k] + smooth[k] + merge[k] for k in launches}, rows


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
        if out != {"ring_launches": 1, "peer_launches": 0, "halo_path": want_halo}:
            raise AssertionError(f"resamplers ({profile}): {out}, expected one exchange "
                                 f"launch and halo path {want_halo}")
        phase(14, f"{profile} weights, S={SHARDS}, P={P}, L={L}: ring (exchange kernel, "
                  f"{out['ring_launches']} launch) and halo resamplers equal resample_state "
                  f"bit for bit in every field, {'halo' if want_halo else 'fallback'} path, "
                  f"{time.perf_counter() - t0:.2f} s")


def same_run(r, o):
    """Two dry-run results of one mode equal bit for bit: estimates and
    every field of the gathered state."""
    import torch

    return torch.equal(r["est"], o["est"]) and all(
        (v is None and getattr(o["state"], k) is None) or torch.equal(v, getattr(o["state"], k))
        for k, v in r["state"].__dict__.items())


def sharded_config():
    return config(resample_threshold_frac=1.0)


def phase15():
    """The sharded main path at full width, then S=1 and the single-device
    steps on the same draws, bit for bit."""
    from fastslam_tpu_torch.core.state import pad_measurements
    from fastslam_tpu_torch.parallel import dryrun

    cfg = sharded_config()
    results, launches, wall = counted_run(lambda: dryrun.dryrun_multichip(
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
            if not same_run(r, other[mode]):
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
    runs, launches, wall = counted_run(lambda: (
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


def phase18_deflate(state):
    """Each member the encoder takes of the blocks ``state`` through
    ``deflate_fixed`` and its plain version on a CPU copy, equal byte for
    byte; per member ``(name, bytes, stream bytes, ms, plain ms, bound)``."""
    import torch

    from fastslam_tpu_torch.core import cuda_kernels
    from fastslam_tpu_torch.io.checkpoint import encoder_members

    rows = []
    for name, t, row in encoder_members(state):
        stream, info = cuda_kernels.deflate_fixed(t, row, 0)
        host = t.cpu()
        t0 = time.perf_counter()
        want, want_info = cuda_kernels.deflate_fixed_ref(host, row, 0)
        plain = (time.perf_counter() - t0) * 1e3
        same = torch.equal(stream.cpu(), want)
        if not (same and torch.equal(info.cpu(), want_info)):
            raise AssertionError(f"deflate_fixed on {name} {tuple(t.shape)}: info "
                                 f"{info.tolist()}, plain {want_info.tolist()}, streams "
                                 f"{'equal' if same else 'differ'}")
        n = (int(want_info[0]) + 7) // 8
        rows.append((name, t.nbytes, n, time_ms(lambda: cuda_kernels.deflate_fixed(t, row, 0), 5),
                     plain, bound_ms(t.nbytes + n, 0)[0]))
    return rows


def phase18(log, online_est, online_wall):
    """The fused online loop of phase 12 with every production hook on, and
    the checkpoint's encoder on the state it wrote."""
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
        hist, launches, wall = counted_run(lambda: run_driver(
            ReplayDriver(log), adaptive_config(), rng=0, device=DEVICE,
            serialize_path=snap, serialize_every=10, metrics_path=metrics,
            checkpoint_path=ckpt, checkpoint_every=150, health=True))
        check_fused("hooked online loop", log, hist, launches, 0.05, HOOKED_FUSED_LAUNCHES)
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
        deflate = phase18_deflate(state)
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
    for name, nbytes, n, ms, plain, bound in deflate:
        phase(18, f"deflate_fixed on the checkpoint's {name} ({nbytes:,} B, stream {n:,} B): "
                  f"equal to deflate_fixed_ref byte for byte; {ms:.4f} ms (bound {bound:.4f}), "
                  f"plain {plain:.1f} ms")
    total = lambda i: sum(r[i] for r in deflate)
    return launches, (total(3), total(4), None), (total(5), "bytes")


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

    (poses, (rot, trans), tick_s), launches, _ = counted_run(run)
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


# phases 22-24: the 2-D particle x map mesh, the engine across processes, and
# its sharded checkpoint, all on the one card
MESH2D = (4, 2)      # particle rows x map shards of phase 22
BLOCKS_MODES = ("blocks motion parity", "blocks motion production", "blocks fs2")
MP_PROCESSES, MP_SHARDS = 2, 2   # phase 23: processes on the card, shards in each
MP_MODES = BLOCKS_MODES + ("planes fs2", "chunked motion", "chunked fs2")
MP_TIMEOUT = 600     # seconds for the two processes of phases 23-24
RING_EXCHANGES = 20  # phases 23 and 26: exchanges each against the plain one
RING_REPS = 10       # calls per timed turn of the exchanges and resamplers
RING_PROCESSES = 4   # phase 26: processes of one shard each


def mesh2d_times(mesh2d):
    """ms per tick of the blocks step on the 4 x 2 mesh, on the 1-D mesh at
    S = 1 and S = 4 (as many particle rows) and on the single-device step, in
    turns (CUDA events over 5 ticks, each after the state of the previous
    one; the config's resample threshold)."""
    import torch

    from fastslam_tpu_torch.core import kernels
    from fastslam_tpu_torch.core.state import init_state, pad_measurements
    from fastslam_tpu_torch.parallel.mesh import make_mesh, shard_state
    from fastslam_tpu_torch.parallel.sharded import make_sharded_step

    times = {}
    for proposal in ("motion", "fastslam2"):
        cfg = config(proposal_mode=proposal)
        ms = pad_measurements(cfg, MEASUREMENTS, DEVICE)
        draws = kernels.draw(torch.Generator(device=DEVICE).manual_seed(22), P,
                             fs2=proposal == "fastslam2")
        meshes = {"S=1": make_mesh(cfg, [DEVICE]), "S=4": make_mesh(cfg, [DEVICE] * 4),
                  "4x2": mesh2d}
        for name in ("S=1", "S=4", "4x2", "single", "4x2", "S=4", "S=1", "single"):
            if name == "single":
                holder = [init_state(cfg, DEVICE)]
                step = lambda s: kernels.fastslam_step(s, 0.0, 0.4, ms, cfg, draws)
            else:
                holder = [shard_state(init_state(cfg, DEVICE), meshes[name], cfg)]
                sharded = make_sharded_step(cfg, meshes[name])
                step = lambda s, sharded=sharded: sharded(s, 0.0, 0.4, ms, draws)

            def run():
                holder[0], _ = step(holder[0])
            times.setdefault((proposal, name), []).append(time_ms(run, 5))
    return times


def phase22():
    """The blocks step on a 4 x 2 particle x map mesh of the card at full
    width: one launch of the per-tick kernel per particle row per tick, bit
    for bit S = 1 and the single-device step; ms per tick beside them."""
    from fastslam_tpu_torch.core.state import pad_measurements
    from fastslam_tpu_torch.parallel import dryrun
    from fastslam_tpu_torch.parallel.mesh import make_mesh

    cfg = sharded_config()
    ms = pad_measurements(cfg, MEASUREMENTS, DEVICE)
    rows, maps = MESH2D
    mesh = make_mesh(cfg, [DEVICE] * (rows * maps), map_parallelism=maps)
    if mesh.shape != {"particles": rows, "map": maps}:
        raise AssertionError(f"mesh shape {mesh.shape}")
    results, launches, wall = counted_run(lambda: dryrun.run_steps(
        cfg, None, DEVICE, ms, ticks=3, modes=BLOCKS_MODES, mesh=mesh))
    expected = {k: 0 for k in launches} | {"fused_update_planes": rows * 3 * len(BLOCKS_MODES)}
    if launches != expected:
        raise AssertionError(f"2-D mesh launches {launches}, expected {expected}")
    phase(22, f"blocks step on a {rows} x {maps} mesh of the card, P={P} L={L} M={M}, "
              f"{len(BLOCKS_MODES)} modes x 3 ticks, forced resamples: wall {wall:.2f} s, "
              f"launches {launches}")
    others = {n: dryrun.run_steps(cfg, n, DEVICE, ms, ticks=3, modes=BLOCKS_MODES)
              for n in (1, None)}
    for mode, r in results.items():
        if r["launches"] != {"fused_update_planes": rows * 3}:
            raise AssertionError(f"{mode}: launches {r['launches']}, expected {rows * 3}")
        for n, other in others.items():
            if not same_run(r, other[mode]):
                raise AssertionError(f"{mode}: the {rows} x {maps} mesh differs from "
                                     f"{'1 shard' if n else 'the single-device step'}")
        phase(22, f"{mode}: {rows * 3} launches of fused_update_planes (one per particle "
                  f"row per tick), shard lm_mean {tuple(r['shards'][0].lm_mean.shape)}, bit for "
                  f"bit the same at S=1 and on the single-device step")
    times = mesh2d_times(mesh)
    for proposal in ("motion", "fastslam2"):
        phase(22, f"blocks step, {proposal}, P={P} L={L} M={M} (config threshold): " + ", ".join(
            f"{name} {min(v):.4f} ms per tick (runs {' / '.join(f'{x:.4f}' for x in v)})"
            for (p_, name), v in times.items() if p_ == proposal))
    return launches, times


def digest(t):
    """A tensor's dtype, shape and SHA-256 of its bytes: equal digests are
    equal tensors."""
    import hashlib

    host = t.detach().cpu().contiguous()
    return str(host.dtype), tuple(host.shape), hashlib.sha256(host.numpy().tobytes()).hexdigest()


def state_digests(state):
    return {k: None if v is None else digest(v) for k, v in state.__dict__.items()}


def mp_tick_times(cfg, mesh, ms):
    """ms per tick of this process on the 2-process mesh (host clock, the
    device synchronised), the host ms per tick in collectives and the bytes
    per tick this process received through the group: the blocks step with
    no resample, with the whole-state gather, with the halo resampler, and
    one chunk of the chunked planes step (motion, fs2), each after one
    warm-up tick or chunk."""
    import torch

    from fastslam_tpu_torch.core import kernels
    from fastslam_tpu_torch.core.state import Measurements, init_planes_state, init_state
    from fastslam_tpu_torch.parallel import collectives
    from fastslam_tpu_torch.parallel.mesh import shard_planes_state, shard_state
    from fastslam_tpu_torch.parallel.sharded import (
        make_sharded_planes_chunked_step, make_sharded_step,
    )

    chunk_ms = Measurements(*tiled(ms))
    rots, trans = torch.zeros(C, device=DEVICE), torch.full((C,), 0.4, device=DEVICE)
    runs = (("blocks motion, no resample", dict(resample_threshold_frac=0.0), 5),
            ("blocks motion, whole-state gather", dict(resample_threshold_frac=1.0), 3),
            ("blocks motion, halo resample",
             dict(resample_threshold_frac=1.0, distributed_resample=True), 3),
            ("chunked motion", dict(resample_threshold_frac=1.0), 2),
            ("chunked fs2", dict(resample_threshold_frac=1.0, proposal_mode="fastslam2"), 2))
    out = {}
    for tag, changes, n in runs:
        c = cfg.replace(**changes)
        gen = torch.Generator(device=DEVICE).manual_seed(23)
        if tag.startswith("chunked"):
            state = shard_planes_state(init_planes_state(c, DEVICE), mesh, c)
            step = make_sharded_planes_chunked_step(c, mesh, C)
            tick = lambda s, step=step, c=c: step(s, rots, trans, chunk_ms, kernels.draw(
                gen, P, C, fs2=kernels.uses_fs2(c)))
            ticks = n * C
        else:
            state = shard_state(init_state(c, DEVICE), mesh, c)
            step = make_sharded_step(c, mesh)
            tick = lambda s, step=step: step(s, 0.0, 0.4, ms, kernels.draw(gen, P))
            ticks = n
        state, _ = tick(state)
        torch.cuda.synchronize()
        before = dict(collectives.TRAFFIC)
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = tick(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[tag] = {"ms_per_tick": wall / ticks * 1e3,
                    "collective_ms_per_tick":
                        (collectives.TRAFFIC["seconds"] - before["seconds"]) / ticks * 1e3,
                    "bytes_per_tick": (collectives.TRAFFIC["bytes"] - before["bytes"]) / ticks,
                    "calls_per_tick": (collectives.TRAFFIC["calls"] - before["calls"]) / ticks}
    return out


def mp_checkpoint(results, mesh, outdir):
    """Phase 24 in each process: save the blocks and the planes state of the
    2-process run with their generator, load both into fresh templates, bit
    for bit; seconds to save and to load, bytes on disk."""
    import os

    import torch
    import torch.distributed as dist

    from fastslam_tpu_torch.core.state import init_planes_state, init_state
    from fastslam_tpu_torch.io.sharded_checkpoint import (
        load_sharded_checkpoint, save_sharded_checkpoint,
    )
    from fastslam_tpu_torch.parallel.mesh import shard_planes_state, shard_state

    cfg = sharded_config()
    out = {}
    for mode, template_of in (("blocks motion production", lambda: shard_state(
                                  init_state(cfg, DEVICE), mesh, cfg)),
                              ("chunked fs2", lambda: shard_planes_state(
                                  init_planes_state(cfg, DEVICE), mesh, cfg))):
        shards = results[mode]["shards"]
        gen = torch.Generator(device=DEVICE).manual_seed(24)
        torch.randn(7, generator=gen, device=DEVICE)
        path = os.path.join(outdir, mode.replace(" ", "_"))
        template = template_of()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        save_sharded_checkpoint(path, shards, mesh=mesh, iteration=3,
                                robot_pose=[1.2, 0.0, 0.0], generator=gen)
        dist.barrier()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, meta = load_sharded_checkpoint(path, template, mesh=mesh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = all((v is None and getattr(g, k) is None)
                   or (getattr(g, k).device == v.device and torch.equal(getattr(g, k), v))
                   for g, s in zip(got, shards) for k, v in s.__dict__.items())
        same = same and meta["iteration"] == 3 and torch.equal(
            torch.randn(5, generator=meta["generator"], device=DEVICE),
            torch.randn(5, generator=gen, device=DEVICE))
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        out[mode] = {"save_s": save_s, "load_s": load_s, "bytes": nbytes, "same": same,
                     "files": sorted(os.listdir(path))}
    return out


def mp_worker(rank: int, port: int, outdir: str) -> int:
    """One of phase 23's processes: gloo on the card, 2 shards of the
    4-shard mesh; the main path's modes with their launches counted,
    their estimates and the digests of their gathered states, the tick
    times, phase 24's checkpoint, then both resamplers across the processes
    (their launches counted), the exchanges against the plain one and
    their times."""
    import os

    import torch
    import torch.distributed as dist

    from fastslam_tpu_torch.core import cuda_kernels
    from fastslam_tpu_torch.core.state import pad_measurements
    from fastslam_tpu_torch.parallel import dryrun
    from fastslam_tpu_torch.parallel.mesh import make_mesh
    from fastslam_tpu_torch.parallel.multihost import initialize_distributed
    from fastslam_tpu_torch.probes import check_ring_resample

    if not torch.cuda.is_available():
        print("chip_smoke worker: no CUDA device", file=sys.stderr)
        return 1
    info = initialize_distributed(f"localhost:{port}", MP_PROCESSES, rank, backend="gloo")
    cfg = sharded_config()
    ms = pad_measurements(cfg, MEASUREMENTS, DEVICE)
    mesh = make_mesh(cfg, [DEVICE] * MP_SHARDS)
    results, launches, wall = counted_run(lambda: dryrun.run_steps(
        cfg, None, DEVICE, ms, chunk=C, ticks=3, modes=MP_MODES, mesh=mesh))
    out = {"info": info, "backend": dist.get_backend(), "launches": launches, "wall": wall,
           "mesh": (mesh.process_index, mesh.num_processes, mesh.num_shards),
           "modes": {m: {"est": r["est"].cpu(), "digests": state_digests(r["state"]),
                         "launches": r["launches"], "local": len(r["shards"])}
                     for m, r in results.items()}}
    out["times"] = mp_tick_times(cfg, mesh, ms)
    out["checkpoint"] = mp_checkpoint(results, mesh, outdir)
    # both resamplers across the processes, on the halo path and the fallback
    out["resamplers"], out["ring_launches"], _ = counted_run(lambda: {
        profile: dryrun.check_resamplers(cfg, None, DEVICE, profile, 0.0042, seed=14, mesh=mesh)
        for profile in ("healthy", "collapsed")})
    device = torch.device(DEVICE, torch.cuda.current_device())
    out["exchange"] = check_ring_resample.check_exchanges(cfg, mesh, device, RING_EXCHANGES)
    out["back_to_back"] = check_ring_resample.check_back_to_back(cfg, mesh, device,
                                                                 RING_EXCHANGES)
    out["ring_times"] = check_ring_resample.times(cfg, mesh, device, RING_REPS)
    out["ring_waits"] = cuda_kernels.peer_ring_stats(mesh.group)
    cuda_kernels.close_peer_rings(mesh.group)
    torch.save(out, os.path.join(outdir, f"worker_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(outdir):
    """Start both processes of phase 23 on a free local port and wait for
    them; a worker that fails, or outlives ``MP_TIMEOUT``, fails the run,
    and both are stopped either way."""
    import os

    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(rank),
                               str(port), outdir], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for rank in range(MP_PROCESSES)]
    try:
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=MP_TIMEOUT)
            if proc.returncode != 0:
                raise AssertionError(f"worker {rank} exited {proc.returncode}:\n"
                                     f"{stdout[-3000:]}\n{stderr[-3000:]}")
    finally:
        for proc in procs:
            proc.kill()
            proc.wait(timeout=60)


def phase23():
    """The engine across 2 processes of the card on gloo, 2 shards each:
    every mode bit for bit one process at S = 4; then phase 24's checkpoint
    from the same processes."""
    import os
    import shutil

    import torch

    from fastslam_tpu_torch.core.state import pad_measurements
    from fastslam_tpu_torch.parallel import dryrun

    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                          "chip_smoke_multiprocess")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    t0 = time.perf_counter()
    run_workers(outdir)
    wall = time.perf_counter() - t0
    workers = [torch.load(os.path.join(outdir, f"worker_{r}.pt"), weights_only=False)
               for r in range(MP_PROCESSES)]
    cfg = sharded_config()
    ms = pad_measurements(cfg, MEASUREMENTS, DEVICE)
    ref = dryrun.run_steps(cfg, MP_PROCESSES * MP_SHARDS, DEVICE, ms, chunk=C, ticks=3,
                           modes=MP_MODES)
    launches = {}
    for rank, w in enumerate(workers):
        if w["backend"] != "gloo" or w["mesh"] != (rank, MP_PROCESSES, MP_PROCESSES * MP_SHARDS):
            raise AssertionError(f"worker {rank}: backend {w['backend']}, mesh {w['mesh']}")
        for k, v in w["launches"].items():
            launches[k] = launches.get(k, 0) + v
    phase(23, f"{MP_PROCESSES} processes on the card ({workers[0]['info']}), gloo, "
              f"{MP_SHARDS} shards each, P={P} L={L} M={M} C={C}: wall {wall:.2f} s for both "
              f"(start, build load, phases 23-24); launches of both {launches}")
    for mode in MP_MODES:
        layout, _, kernel = dryrun.MODES[mode]
        want = {kernel: MP_SHARDS * (3 if layout in ("blocks", "planes") else 1)}
        for rank, w in enumerate(workers):
            got = w["modes"][mode]
            if got["launches"] != want or got["local"] != MP_SHARDS:
                raise AssertionError(f"{mode}, worker {rank}: launches {got['launches']}, "
                                     f"expected {want}; {got['local']} local shards")
            if not (torch.equal(got["est"], ref[mode]["est"].cpu())
                    and got["digests"] == state_digests(ref[mode]["state"])):
                raise AssertionError(f"{mode}, worker {rank}: differs from one process at "
                                     f"S={MP_PROCESSES * MP_SHARDS}")
        phase(23, f"{mode}: {want[kernel]} launches per process, estimates and the gathered "
                  f"state the same in both processes and bit for bit one process at "
                  f"S={MP_PROCESSES * MP_SHARDS}")
    for tag in workers[0]["times"]:
        phase(23, f"{tag}: " + "; ".join(
            f"process {rank} {w['times'][tag]['ms_per_tick']:.3f} ms per tick, "
            f"{w['times'][tag]['collective_ms_per_tick']:.3f} of it host time in collectives, "
            f"{w['times'][tag]['bytes_per_tick'] / 1e6:.3f} MB per tick received through the "
            f"group in {w['times'][tag]['calls_per_tick']:.2f} calls"
            for rank, w in enumerate(workers)))
    for mode in workers[0]["checkpoint"]:
        for rank, w in enumerate(workers):
            c = w["checkpoint"][mode]
            if not c["same"]:
                raise AssertionError(f"checkpoint of {mode}, worker {rank}: not bit for bit")
        c = workers[0]["checkpoint"][mode]
        phase(24, f"save_sharded_checkpoint of the {MP_PROCESSES}-process {mode} state: "
                  f"{c['bytes'] / 1e6:.1f} MB on disk in {c['files']}; save "
                  + " / ".join(f"{w['checkpoint'][mode]['save_s']:.3f}" for w in workers)
                  + " s, load " + " / ".join(f"{w['checkpoint'][mode]['load_s']:.3f}"
                                             for w in workers)
                  + " s (process 0 / 1); both processes load it back bit for bit, with "
                    "the generator")
    ring = check_ring_workers(workers)
    return launches, ring, workers


def check_ring_workers(workers):
    """Phase 23's ring across the processes: both resamplers bit for bit
    with one launch of the cross-process kernel per process per call, the
    exchanges bit for bit; returns the launches of both processes' resample
    run and the exchanges' largest difference."""
    want = {"healthy": {"ring_launches": 0, "peer_launches": 1, "halo_path": 1},
            "collapsed": {"ring_launches": 0, "peer_launches": 1, "halo_path": 0}}
    launches = {}
    for rank, w in enumerate(workers):
        if w["resamplers"] != want:
            raise AssertionError(f"worker {rank}: resamplers across processes "
                                 f"{w['resamplers']}, expected {want}")
        expected = {k: 0 for k in w["ring_launches"]} | {PEERS: 2}
        if w["ring_launches"] != expected:
            raise AssertionError(f"worker {rank}: resample launches {w['ring_launches']}, "
                                 f"expected {expected}")
        for key in ("exchange", "back_to_back"):
            ex = w[key]
            if not ex["equal"] or ex["max_abs_err"] or ex["launches"] != RING_EXCHANGES:
                raise AssertionError(f"worker {rank}: {key} against the plain one {ex}")
        for k, v in w["ring_launches"].items():
            launches[k] = launches.get(k, 0) + v
    phase(23, f"ring_halo_resample across {MP_PROCESSES} processes x {MP_SHARDS} shards, "
              f"P={P} L={L}: it and the halo resampler equal resample_state bit for bit on "
              f"healthy weights (halo path) and collapsed ones (fallback), "
              f"{want['healthy']['peer_launches']} launch of {PEERS} per process per call; "
              f"{RING_EXCHANGES} exchanges on new blocks, and {RING_EXCHANGES} back to back, "
              f"each equal to the plain exchange bit for bit in both processes, max abs err "
              f"{max(w[k]['max_abs_err'] for w in workers for k in ('exchange', 'back_to_back'))}")
    for rank, w in enumerate(workers):
        t = w["ring_times"]
        phase(23, f"process {rank}: ms per call in turns, {RING_REPS} calls each: exchange "
                  f"kernel {' / '.join(f'{x:.3f}' for x in t['kernel'])}, plain (gloo) "
                  f"{' / '.join(f'{x:.3f}' for x in t['plain'])}; ring_halo_resample "
                  f"{' / '.join(f'{x:.3f}' for x in t['ring'])}, halo resampler (gloo) "
                  f"{' / '.join(f'{x:.3f}' for x in t['halo'])}; {ring_waits(w['ring_waits'])}")
    return launches, max(w[k]["max_abs_err"] for w in workers
                         for k in ("exchange", "back_to_back"))


def ring_waits(waits):
    """One process's waits of the cross-process exchange, as a phase line
    reads them (``core/cuda_kernels/ring.py:peer_ring_stats``)."""
    per_call = lambda k: waits[k] / max(waits["calls"], 1)
    return (f"wait (a) found its words already set in {waits['entered_met']} of "
            f"{waits['calls']} calls, longest {waits['entered_max_ms']:.4f} ms; device ms per "
            f"call: wait (a) {per_call('entered_ms'):.4f}, copy {per_call('copy_ms'):.4f}, "
            f"wait (c) {per_call('delivered_ms'):.4f}")


def phase26(mp_workers):
    """The ring across four processes of one shard each: every neighbour in
    another process.  Returns the launches of the processes' resample run
    (summed), the exchanges' largest difference and the times."""
    from fastslam_tpu_torch.probes import check_ring_resample

    t0 = time.perf_counter()
    out = check_ring_resample.run(RING_PROCESSES, 1, P, L, DEVICE, RING_EXCHANGES, RING_REPS,
                                  timeout=MP_TIMEOUT)
    wall = time.perf_counter() - t0
    if not out["ok"]:
        raise AssertionError(f"ring across {RING_PROCESSES} processes: {out}")
    launches = {}
    for per_process in out["launches"]:
        if per_process != {k: 0 for k in per_process} | {PEERS: 2}:
            raise AssertionError(f"ring across {RING_PROCESSES} processes: resample launches "
                                 f"{per_process}, expected 2 of {PEERS}")
        for k, v in per_process.items():
            launches[k] = launches.get(k, 0) + v
    phase(26, f"ring_halo_resample across {RING_PROCESSES} processes x 1 shard, P={P} L={L} "
              f"(wall {wall:.2f} s): equal to resample_state bit for bit, healthy and "
              f"collapsed, one launch of {PEERS} per process per call; {RING_EXCHANGES} "
              f"exchanges, and {RING_EXCHANGES} back to back, each equal to the plain exchange "
              f"bit for bit (max abs err "
              f"{max(out['exchange']['max_abs_err'], out['back_to_back']['max_abs_err'])})")
    for rank, waits in enumerate(out["waits"]):
        phase(26, f"process {rank}: {ring_waits(waits)}")
    span = lambda xs: f"{min(xs):.3f}-{max(xs):.3f}"
    times = {k: [x for t in out["times"] for x in t[k]] for k in out["times"][0]}
    before = {k: [x for w in mp_workers for x in w["ring_times"][k]] for k in times}
    phase(26, f"ms per call over the {RING_PROCESSES} processes, in turns: exchange kernel "
              f"{span(times['kernel'])} (phase 23, 2 x 2: {span(before['kernel'])}), plain "
              f"(gloo) {span(times['plain'])} ({span(before['plain'])}); ring_halo_resample "
              f"{span(times['ring'])} ({span(before['ring'])}), halo resampler (gloo) "
              f"{span(times['halo'])} ({span(before['halo'])})")
    return (launches, max(out["exchange"]["max_abs_err"], out["back_to_back"]["max_abs_err"]),
            times)



# phase 25: the accuracy matrix's scale section (fastslam_tpu_torch/eval/suite.py)
# at seed 3 and rng 0 on the card, beside the JAX suite's seed-3 values
ACCURACY_REPEAT = "production chunked C=16 (N=100k, H100)"
ACCURACY_SLIP_GATED = "production+fs2+adaptive chunked C=8 (N=100k, H100, wheel slip)"
# the per-tick rows and chunk tails, the chunked rows, the adaptive rows' ICP stage
ACCURACY_KERNELS = {"fused_update_planes", "fused_update_planes_multi", "fused_fs2_planes",
                    "fused_fs2_planes_multi", "icp_point_to_line"}


def phase25(card):
    """``suite.section_scale`` at seed 3, rng 0: all 13 rows at full width,
    each production row gated by its table's oracle row, and one row run
    again bit for bit."""
    import os

    import numpy as np

    from fastslam_tpu_torch.eval import suite
    from fastslam_tpu_torch.eval.metrics import ate_rmse

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "eval_results", "scale.json")) as f:
        jax_blob = json.load(f)
    jax_seed3 = {k: v[jax_blob["seeds"].index(3)] for k, v in jax_blob["rows"].items()}
    args = suite.parse_args(["--seeds", "3", "--rngs", "0", "--device", DEVICE])

    def run():
        _, table = suite.section_scale(args)
        log, gt = suite.make_log(3, args.ticks)
        again = [suite.run_estimates(log, dict(num_particles=P, parity_mode=False),
                                     chunked=True, chunk_size=16, device=DEVICE)
                 for _ in range(2)]
        return table, gt, again

    (table, gt, again), launches, wall = counted_run(run)
    rows = {name: v[0][0] for name, v in table.rows.items()}
    if len(rows) != 13 or not all(np.isfinite(v) for v in rows.values()):
        raise AssertionError(f"scale section at seed 3: {rows}")
    for name, ate in rows.items():
        ran = {k: n for k, n in table.launches[name].items() if n}
        phase(25, f"{name}: ATE {ate:.4f} m (JAX seed 3: "
                  f"{jax_seed3[name.replace('H100', 'TPU')]:.4f}); launches {ran or 'none'}")
    oracle, slip_oracle = (name for name in rows if name.startswith("reference"))
    names = list(rows)
    clean = [n for n in names[names.index(oracle) + 1:names.index(slip_oracle)]
             if n.startswith("production")]
    above = {n: rows[n] for n in clean if not rows[n] < rows[oracle]}
    if len(clean) != 9 or above:
        raise AssertionError(f"clean production rows at or above the oracle's "
                             f"{rows[oracle]:.4f} m: {above} ({len(clean)} clean rows)")
    if not rows[ACCURACY_SLIP_GATED] < rows[slip_oracle]:
        raise AssertionError(f"{ACCURACY_SLIP_GATED}: {rows[ACCURACY_SLIP_GATED]:.4f} m, not "
                             f"below the slip oracle's {rows[slip_oracle]:.4f} m")
    repeat_ate = ate_rmse(gt[:, :2], again[0][:, :2])
    if not (np.array_equal(again[0], again[1]) and repeat_ate == rows[ACCURACY_REPEAT]):
        raise AssertionError(f"{ACCURACY_REPEAT}: a second run does not repeat its estimates "
                             f"(ATE {repeat_ate} against {rows[ACCURACY_REPEAT]})")
    ran = {k for k, n in launches.items() if n}
    if not ran >= ACCURACY_KERNELS:
        raise AssertionError(f"the scale section launched {sorted(ran)}, not every kernel "
                             f"of {sorted(ACCURACY_KERNELS)}")
    phase(25, f"scale section at seed 3, rng 0 on {card}: the {len(clean)} clean production "
              f"rows {min(rows[n] for n in clean):.4f}-{max(rows[n] for n in clean):.4f} m, "
              f"all below the oracle's {rows[oracle]:.4f}; fs2+adaptive under slip "
              f"{rows[ACCURACY_SLIP_GATED]:.4f} below the slip oracle's "
              f"{rows[slip_oracle]:.4f} (motion-only under slip, not gated: "
              f"{rows['production chunked C=8 (N=100k, H100, wheel slip)']:.4f}); "
              f"{ACCURACY_REPEAT} run twice more, the same estimates bit for bit; wall "
              f"{wall:.1f} s; launches {launches}")
    # the same row on phase 4's drive (start (0, 0, 0), no range noise) and on
    # make_log's seed-3 start without range noise: which of the two sets the
    # gap between phase 4's ATE and this row's
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld

    for label, log in (
            ("phase 4's drive", record_log(SimWorld(seed=3), num_ticks=300)),
            ("make_log's seed-3 start, no range noise",
             suite.make_log(3, args.ticks, range_noise_std=0.0)[0])):
        gt = suite.start_frame(log.gt_poses)
        ates = [suite.run_mode(log, gt, dict(num_particles=P, parity_mode=False), chunked=True,
                               chunk_size=16, rng=rng, device=DEVICE) for rng in (0, 1, 2)]
        phase(25, f"{ACCURACY_REPEAT} on {label}: ATE at rngs 0, 1, 2 "
                  + ", ".join(f"{a:.4f}" for a in ates) + " m (not gated)")
    return launches


def check_parity_line(r):
    """One check's result of ``probes.check_parity`` as a phase line."""
    diffs = ", ".join(
        f"{k} {'max' if 'max' in d else 'q99'} {d.get('max', d.get('q99')):.3e} (bar "
        f"{d['bar']:g}" + (f"; {100 * d['over']:.2f} % past it)" if "over" in d else ")")
        for k, d in r["diffs"].items())
    if "flip_frac" in r:
        head = f"{100 * r['flip_frac']:.2f} % count flips (bar {100 * r['flip_bar']:g} %)"
    else:
        head = f"counts {'equal' if r['cnt_equal'] else 'DIFFER'}"
    est = r.get("estimates")
    tail = (f"; per-tick estimates max {est['max']:.3e} (bar {est['bar']:g}), "
            f"{est['same_pick']} ticks the same particle, {est['ties']} ties" if est else "")
    return (f"{r['check']} (row {r['row']}, {r['kernel']}, {r['form']}) P={r['particles']} "
            f"L={r['L']} M={r['M']}, {r['ticks']} ticks: {head}; {diffs}{tail}; launches "
            f"{r['launches']}: {'ok' if r['ok'] else 'BROKEN'}")


def phase27(card):
    """``probes.check_parity``: the card's filter kernels against the CPU
    plain path at ``scripts/check_pallas_parity.py``'s bars."""
    from fastslam_tpu_torch.probes import check_parity

    t0 = time.perf_counter()
    results = check_parity.run(DEVICE, print_lines=False)
    for r in results:
        phase(27, check_parity_line(r))
    broken = [f"{r['check']} P={r['particles']}" for r in results if not r["ok"]]
    if broken:
        raise AssertionError(f"check_parity: bars broken: {', '.join(broken)}")
    phase(27, f"check_parity on {card}: {len(results)} checks within the reference's bars "
              f"in {time.perf_counter() - t0:.1f} s")


def finite_record(tag, rec):
    import numpy as np

    bad = [k for k, v in rec.items() if not np.all(np.isfinite(np.asarray(v, float)))]
    if bad:
        raise AssertionError(f"{tag}: keys not finite: {bad}")


def phase28(card):
    """``eval.diagnose_slip``: the online form at seed 3 under slip, N=100,
    twice, and the trace form on the corridor trace at rng 0 with its
    oracle, its engine again."""
    import os

    from fastslam_tpu_torch.eval import diagnose_slip

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    corridor = os.path.join(root, "data", "jderobot", "corridor_seed3_300.jsonl")

    def run():
        online = [diagnose_slip.run_instrumented(3, particles=100, device=DEVICE)
                  for _ in range(2)]
        trace = diagnose_slip.run_trace(corridor, 0, device=DEVICE)
        again = diagnose_slip.run_trace(corridor, 0, device=DEVICE, oracle=False)
        return online, trace, again

    (online, trace, again), launches, _ = counted_run(run)
    finite_record("diagnose_slip online", online[0])
    if online[0] != online[1]:
        raise AssertionError("diagnose_slip online: a second run differs")
    diagnose_slip.summarize(online[0], f"seed 3 slip N=100 on {card}")
    finite_record("diagnose_slip --trace", trace)
    engine = {k: v for k, v in trace.items() if not k.startswith("oracle")}
    if engine != again:
        raise AssertionError("diagnose_slip --trace: a second engine run differs")
    parts = diagnose_slip.parting_ticks(trace)
    if parts["draws"] or parts["differ"] != parts["pairing"]:
        raise AssertionError(f"diagnose_slip --trace: the odometry parts off the pairing "
                             f"rule: {parts}")
    diagnose_slip.print_trace_table(
        diagnose_slip.trace_windows(trace),
        f"corridor_seed3_300 rng 0 on {card}: engine ATE {trace['engine_ate']:.4f}, "
        f"oracle ATE {trace['oracle_ate']:.4f}")
    phase(28, f"diagnose_slip on {card}: online ATE {online[0]['ate']:.4f} m twice bit for "
              f"bit, every key finite; --trace corridor_seed3_300 rng 0: engine ATE "
              f"{trace['engine_ate']:.4f} m (again bit for bit), oracle {trace['oracle_ate']:.4f}"
              f" m, the odometry parting on {len(parts['pairing'])} ticks, all by the pairing "
              f"rule; launches {({k: n for k, n in launches.items() if n})}; "
              f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase29():
    """``io.make_jderobot_trace``: both committed traces recorded again,
    byte for byte."""
    import os

    from fastslam_tpu_torch.io import make_jderobot_trace

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    for name, flags in make_jderobot_trace.COMMITTED.items():
        out = make_jderobot_trace.check(os.path.join(root, "data", "jderobot", name), **flags)
        if not out["equal"]:
            raise AssertionError(f"make_jderobot_trace: {name} differs ({out})")
        phase(29, f"make_jderobot_trace {flags or 'defaults'}: {name} byte for byte "
                  f"({out['ticks']} ticks, sha256 {out['sha256'][:16]})")
    phase(29, f"both traces in {time.perf_counter() - t0:.1f} s")


def step_line(rec):
    """One ``probes.step`` record as a phase line."""
    return (f"{rec['path']}: K={rec['k']} steps in one graph, {rec['step_ms']:.4f} ms per "
            f"tick ({rec['updates_per_s']:,} updates/s"
            + (f", {rec['frames_per_s']} frames/s" if "frames_per_s" in rec else "")
            + f"), eager {rec['eager_step_ms']:.4f} ms per tick; graph = eager bit for bit; "
            f"build and capture {rec['build_and_capture_s']} s; final pose x "
            f"{rec['final_pose_x']}; launches per replay {rec['launches_per_replay']}")


def phase30():
    """``probes.step``: K steps in one captured graph, each path held to its
    eager run bit for bit (the probe raises otherwise)."""
    from fastslam_tpu_torch.probes import step

    paths = (["--planes"], ["--fused-only"], ["--chunk", str(C)], ["--chunk", str(C), "--fs2"],
             ["--planes", "--with-frontend"], [])

    def run():
        out = []
        for flags in paths:
            rec = step.run(step.parse(flags))
            rec.pop("_")
            torch_sync()
            out.append(rec)
        return out

    recs, launches, wall = counted_run(run)
    for rec in recs:
        if not rec["graph"] or rec["draws"] != "eager_static":
            raise AssertionError(f"probes.step {rec['path']}: not timed as a graph ({rec})")
        phase(30, step_line(rec))
    phase(30, f"probes.step: {len(recs)} paths in {wall:.1f} s; launches "
              f"{({k: n for k, n in launches.items() if n})}")
    return launches


def torch_sync():
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase31():
    """``probes.compare``: the blocks step with and without the kernel, and
    rows 1-4 against their plain versions, every pair 0 apart."""
    from fastslam_tpu_torch.probes import compare

    rec, launches, wall = counted_run(lambda: compare.run(DEVICE, plain_steps=1))
    for variant, r in rec["blocks_step"].items():
        phase(31, f"blocks step, {variant}: {r['step_ms']:.4f} ms per step, "
                  f"{r['updates_per_s']:,} updates/s, pose {r['pose']}, lm_count[0] "
                  f"{r['lm_count0']}")
    for r in rec["planes_kernels"]:
        if r["max_abs_diff"] != 0.0:
            raise AssertionError(f"probes.compare row {r['row']}: {r['kernel']} differs from "
                                 f"its plain version by {r['max_abs_diff']}")
        phase(31, f"row {r['row']} {r['kernel']}: {r['ms']:.4f} ms per tick, plain "
                  f"{r['plain_ms']:.4f} ({r['updates_per_s']:,} vs {r['plain_updates_per_s']:,} "
                  f"updates/s), max |diff| 0")
    r = rec["resample"]
    if r["max_abs_diff"] != 0.0:
        raise AssertionError(f"probes.compare: the resample's kernels differ from their plain "
                             f"versions by {r['max_abs_diff']}")
    phase(31, f"resample at P={P} L={L}: {r['ms']['due']:.4f} ms due (staircase "
              f"{r['staircase_ms']['due']:.4f}, gather {r['gather_ms']['due']:.4f}; bound "
              f"{r['bound_ms']['due']:.4f}), {r['ms']['not_due']:.4f} ms not due (staircase "
              f"{r['staircase_ms']['not_due']:.4f}, gather {r['gather_ms']['not_due']:.4f}; "
              f"bound 0); plain {r['plain_ms']:.4f}, ATen (torch.cummax, index_select) "
              f"{r['library_ms']:.4f}; max |diff| 0")
    phase(31, f"probes.compare in {wall:.1f} s; launches "
              f"{({k: n for k, n in launches.items() if n})}")
    return launches, r


def phase32():
    """``probes.e2e_attribution``: the K-sweep, the frontend and the filter
    alone, the fused tick."""
    import math

    from fastslam_tpu_torch.probes import e2e_attribution

    rec, launches, wall = counted_run(lambda: e2e_attribution.run(DEVICE, out_path=None))
    tick = rec["fused_tick"]
    numbers = [*rec["e2e_ms_per_tick_by_k"].values(), rec["per_tick_ms_asymptotic"],
               rec["frontend_ms_per_tick"], rec["filter_ms_per_tick"], tick["wall_ms_median"],
               tick["device_ms_per_replay"]]
    if not all(math.isfinite(x) and x > 0 for x in numbers):
        raise AssertionError(f"probes.e2e_attribution: a time is not positive ({rec})")
    if tick["graph_replays"] != tick["ticks"] - 1:
        raise AssertionError(f"probes.e2e_attribution: {tick['graph_replays']} replays")
    phase(32, f"e2e ms per tick by K {rec['e2e_ms_per_tick_by_k']} (capture s "
              f"{rec['build_and_capture_s_by_k']}): asymptote {rec['per_tick_ms_asymptotic']} "
              f"ms, per-replay constant {rec['per_dispatch_overhead_ms']} ms; frontend "
              f"{rec['frontend_ms_per_tick']} ms, filter {rec['filter_ms_per_tick']} ms per tick")
    phase(32, f"tick_fused over {tick['ticks']} scans: median {tick['wall_ms_median']} ms, "
              f"p90 {tick['wall_ms_p90']} ms (host clock), device {tick['device_ms_per_replay']} "
              f"ms per replay, {tick['gap_to_asymptote_ms']} ms past the asymptote; "
              f"{wall:.1f} s; launches {({k: n for k, n in launches.items() if n})}")
    return launches


def phase33():
    """``probes.collective_bytes`` on 8 shards of the card."""
    from fastslam_tpu_torch.probes import collective_bytes

    shards, per = 8, 8192
    rec, launches, wall = counted_run(lambda: collective_bytes.run(DEVICE, shards, per, L, M))
    want = shards * per * (3 + 1 + 6 * L + 1) * 4
    got = rec["gspmd_resample"]["whole_state_bytes"]
    if got != want:
        raise AssertionError(f"collective tally: whole-state gather {got} B, shapes give {want}")
    if not launches.get(RING):
        raise AssertionError("probes.collective_bytes: the ring resampler launched no exchange")
    for name in collective_bytes.RESAMPLERS:
        r = rec[name]
        phase(33, f"{name}: {r['collective_ops']} ops ({r['scalar_ops']} scalar, "
                  f"{r['scalar_bytes']} B), bulk {r['bulk_bytes_total_mb']} MB "
                  f"(no resample {r['branches']['no_resample']['bulk_bytes_total_mb']}, "
                  f"resample {r['branches']['resample']['bulk_bytes_total_mb']}); by site "
                  f"{r['by_site']}")
    phase(33, f"whole-state gather {got} B = P (3 + 1 + 6 L + 1) 4 at {shards} x {per}; "
              f"{wall:.1f} s; launches {({k: n for k, n in launches.items() if n})}")
    return launches


def phase34():
    """``probes.scaling``: both sharded steps at 1-8 shards of the card."""
    from fastslam_tpu_torch.probes import scaling

    rec, launches, wall = counted_run(lambda: scaling.run(DEVICE, print_rows=False))
    for r in rec["scaling"] + rec["scaling_chunked"]:
        phase(34, f"{r['step']} S={r['devices']} P={r['particles']}: {r['step_ms']:.4f} ms per "
                  f"tick, {r['frames_per_s']} frames/s, efficiency "
                  f"{r['weak_scaling_efficiency']}, equal to one shard bit for bit")
    phase(34, f"{scaling.LABEL}; {wall:.1f} s; launches "
              f"{({k: n for k, n in launches.items() if n})}")
    return launches


# bench.py's keys (bench.py:352-371) and the port's
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "step_seconds", "windows",
              "fs2_step_seconds", "fs2_updates_per_s", "fs2_windows", "e2e_frames_per_s",
              "baseline_updates_per_s", "baseline_updates_per_s_measured",
              "baseline_pin_stale", "device", "power_limit_w", "launches")
BENCH_ROWS = ("fused_update_planes", "fused_update_planes_multi", "fused_fs2_planes_multi")


def phase35():
    """``python -m fastslam_tpu_torch.bench``'s main at full geometry."""
    import contextlib
    import io
    import math

    from fastslam_tpu_torch import bench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, launches, wall = counted_run(lambda: bench.main([]))
    lines = out.getvalue().strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} lines: {lines}")
    print(lines[0], flush=True)
    rec = json.loads(lines[0])
    missing = [k for k in BENCH_KEYS if k not in rec]
    if missing:
        raise AssertionError(f"bench: keys missing {missing}")
    numbers = [v for k, v in rec.items() if k != "launches"
               and isinstance(v, (int, float)) and not isinstance(v, bool)]
    numbers += rec["windows"] + rec["fs2_windows"] + list(rec["launches"].values())
    if not all(math.isfinite(x) and x > 0 for x in numbers):
        raise AssertionError(f"bench: a number is not finite and positive ({rec})")
    if not isinstance(rec["baseline_pin_stale"], bool) or len(rec["windows"]) != 3 \
            or len(rec["fs2_windows"]) != 2:
        raise AssertionError(f"bench: malformed record ({rec})")
    if not all(launches.get(k) for k in BENCH_ROWS) or rec["launches"] != {
            k: n for k, n in launches.items() if n}:
        raise AssertionError(f"bench: launches {rec['launches']}, counters {launches}")
    phase(35, f"bench: {rec['value']:,} updates/s ({rec['step_seconds'] * 1e3:.4f} ms per "
              f"tick; windows {rec['windows']}), fs2 {rec['fs2_updates_per_s']:,} "
              f"({rec['fs2_step_seconds'] * 1e3:.4f} ms; {rec['fs2_windows']}), e2e "
              f"{rec['e2e_frames_per_s']} frames/s, vs_baseline {rec['vs_baseline']} "
              f"(oracle pinned {rec['baseline_updates_per_s']}, measured "
              f"{rec['baseline_updates_per_s_measured']}, stale {rec['baseline_pin_stale']}); "
              f"every window's graph equal to its eager run bit for bit; {wall:.1f} s; "
              f"launches {rec['launches']}")
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
    # the encoder: the sums over the checkpoint's five members
    paths["hooked_online"], times["deflate_fixed"], bounds["deflate_fixed"] = phase18(
        log, online_est, online_wall)
    errs["deflate_fixed"] = 0.0     # byte for byte, or phase 18 raised
    paths["api"] = phase19(log)
    paths["tracked_online"], paths["jderobot"] = phase20(log, card)
    paths["backend"], seg_rows = phase21(log, online_est, card)
    cross = seg_rows["cross"]      # the widest of the backend's sums
    errs["segment_sum"] = 0.0
    times["segment_sum"] = (cross["ms"], cross["plain_ms"], cross["library_ms"])
    bounds["segment_sum"] = cross["bound"]
    paths["mesh2d"], _ = phase22()
    paths["multiprocess"], (paths["multiprocess_ring"], errs[PEERS]), mp_workers = phase23()
    paths["accuracy"] = phase25(card)
    paths["ring_4x1"], err_4x1, times_4x1 = phase26(mp_workers)
    errs[PEERS] = max(errs[PEERS], err_4x1)
    phase27(card)
    paths["slip_diagnosis"] = phase28(card)
    phase29()
    paths["step"] = phase30()
    paths["compare"], resample = phase31()
    for name, part in (("resample_staircase", "staircase_ms"), ("resample_gather", "gather_ms")):
        errs[name] = resample["max_abs_diff"]
        times[name] = (resample[part]["due"], resample["plain_ms"], resample["library_ms"])
    # the bound is the pair's: one read and one write of the state where due
    bounds["resample_staircase"] = bounds["resample_gather"] = (resample["bound_ms"]["due"],
                                                                "bytes")
    paths["e2e_attribution"] = phase32()
    paths["collective_bytes"] = phase33()
    paths["scaling"] = phase34()
    paths["bench"] = phase35()
    # the cross-process exchange: phase 23's times (2 x 2, process 0, the
    # mean of the two turns), no library call (NCCL takes no two ranks on one
    # card); the bound is the whole ring's bytes on the one card
    t23 = mp_workers[0]["ring_times"]
    times[PEERS] = (sum(t23["kernel"]) / 2, sum(t23["plain"]) / 2, None)
    bounds[PEERS] = bound_ms(3 * P * (3 + 1 + 6 * L + 1) * 4, 0)

    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": sum(path.get(name, 0) for path in paths.values()),
         "launches_by_path": {k: path.get(name, 0) for k, path in paths.items()},
         "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": times[name][2]}
        | ({"onchip_bound_ms": onchip} if name == "mul_add" else {})
        | ({"ms_4x1": sum(times_4x1["kernel"]) / len(times_4x1["kernel"]),
            "plain_ms_4x1": sum(times_4x1["plain"]) / len(times_4x1["plain"])}
           if name == PEERS else {})
        | ({"library_f32_ms": cross["library_f32_ms"], "calls": {
            call: {"ms": r["ms"], "eager_ms": r["eager_ms"], "bound_ms": r["bound"][0],
                   "plain_ms": r["plain_ms"],
                   "library_ms": r["library_ms"], "library_f32_ms": r["library_f32_ms"]}
            for call, r in seg_rows.items()}} if name == "segment_sum" else {})
        for name, (src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        import os

        code = mp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        # torch's destructors at interpreter exit sometimes abort a gloo
        # process ("terminate called without an active exception") after its
        # work is done and written: a worker leaves without running them
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    sys.exit(main())
