"""Configuration for the PyTorch/CUDA FastSLAM engine.

A framework-free copy of :class:`fastslam_tpu.config.FastSLAMConfig`: the same
field names and defaults, so a configuration carries across unchanged
(``interop.config_from_jax_fields``).  Four fields of the JAX package are left
out: ``use_pallas``, ``pallas_interpret`` and ``engine`` (here the device of
the tensors decides which path runs, and the caller picks the layout by the
step it calls: the planes steps, or the blocks ``fastslam_step``) and the
retired ``fs2_reuse_association`` lever.

``fuse_online_tick`` (with ``parity_mode=False``) selects the fused online
tick, as in the JAX runner: ICP refinement, frontend or corner tracking and
the filter step as one piece of device work with one readback, on the card
one replay of a captured CUDA graph per tick (``app/runner.py:
SLAMRunner.tick_fused``); otherwise the online loop runs the split path.

The capacity fields (``max_landmarks``, ``max_measurements``,
``max_hough_lines`` ...) turn every ragged structure of the algorithm into a
fixed-capacity masked tensor, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FastSLAMConfig:
    """Static configuration of one filter run."""

    # ---- filter core ----
    num_particles: int = 20
    translation_noise: float = 0.0055     # std-dev of translation noise
    rotation_noise: float = 0.001         # std-dev of rotation noise
    measurement_noise: float = 0.001      # R = measurement_noise * I2
    max_landmark_distance: float = 8.0    # Mahalanobis association gate
    default_landmark_cov: float = 0.1     # new landmark cov = 0.1 * I2

    # ---- static capacities (ragged -> masked fixed shape) ----
    max_landmarks: int = 64               # per-particle landmark slots
    max_measurements: int = 16            # measurements per tick (padded)
    num_beams: int = 180                  # laser beams per scan

    # ---- behavior switches ----
    # parity_mode=True keeps the original FastSLAM code's quirks:
    # robot-frame association, linear-space weight normalization with the
    # <1e-5 skip, first-match association, asymmetric (I-KH)S covariance.
    # parity_mode=False is the production path: world-frame association,
    # log-space weights, best-match association, symmetrized covariance.
    parity_mode: bool = True
    resample_threshold_frac: float = 0.5  # resample when Neff < frac * N
    weight_floor: float = 1e-5            # collapse guard of parity mode

    # ---- frontend: line filter ----
    line_filter_sigma: float = 0.1
    line_filter_truncate: float = 4.0     # scipy gaussian_filter1d default

    # ---- frontend: Hough corner detector ----
    hough_scale: int = 100                # metres -> pixels
    hough_padding: int = 20               # border pixels
    hough_threshold: int = 80             # accumulator votes for a line
    hough_point_radius: int = 2           # rasterized point disc radius
    hough_num_thetas: int = 180           # 1-degree theta bins
    # accumulator extent: +-hough_rho_bins/2 px = +-20.48 m at scale 100.
    # Points beyond it do not vote; raise it for larger worlds.
    hough_rho_bins: int = 4096
    max_hough_lines: int = 24             # top-K detected lines kept
    # production only: weighted total-least-squares refit of each detected
    # line over the scan points within hough_refine_band_px of it
    hough_refine: bool = True
    hough_refine_band_px: float = 3.0
    min_line_angle_deg: float = 45.0      # intersection angle gate
    max_intersections: int = 64
    cluster_eps: float = 0.5              # clustering eps for intersections
    corner_threshold: float = 0.1         # corner-to-scan-point gate

    # ---- corner identity tracking (not ported yet) ----
    track_corners: bool = False
    track_capacity: int = 32
    track_gate: float = 0.4
    track_min_hits: int = 2
    track_max_misses: int = 3
    track_ema: float = 1.0

    # ---- viz landmark clustering ----
    viz_cluster_eps: float = 0.5
    viz_min_samples_frac: float = 0.7

    # ---- ICP and FastSLAM 2.0 proposals, adaptive floors ----
    icp_max_iterations: int = 100
    icp_tolerance: float = 1e-5
    use_icp_proposal: bool = False
    icp_blend: float = 0.5
    # "motion" samples from the motion model alone; "fastslam2" from the
    # measurement-informed posterior
    proposal_mode: str = "motion"
    proposal_xy_floor: float = 0.01
    proposal_theta_floor: float = 0.01
    adaptive_proposal_floors: bool = False
    proposal_floor_min: float = 5e-4
    proposal_floor_max: float = 0.05
    floor_window: int = 40
    blend_min_sigma: float = 0.008
    blend_min_sigma_theta: float = 0.008
    blend_match_gate: float = 8.0
    fs2_mode_dial: bool = True
    fs2_dial_lo_floor: float = 1.5e-3
    fs2_dial_hi_floor: float = 4e-3
    floor_prior_ticks: int = 2
    floor_prior_sigma_xy: float = 0.002
    floor_prior_sigma_theta: float = 0.002
    fs2_evidence_weights: bool = False

    # ---- motion / app loop ----
    fuse_online_tick: bool = True         # production: the fused tick (see above)
    velocity_fudge: float = 0.6           # the simulator absorbs 40% of v
    warmup_iterations: int = 150          # dead-reckoning warmup ticks
    linear_velocity: float = 0.3          # drive policy commands
    angular_velocity: float = 0.5

    # ---- sharding (parallel/: a 1-D particle mesh of shards on one card;
    # the map axis is not ported) ----
    particle_axis: str = "particles"
    map_axis: str = "map"
    distributed_resample: bool = False    # the halo resampler in the sharded blocks step

    # ---- numerics ----
    dtype: str = "float32"

    @property
    def measurement_cov(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        r = self.measurement_noise
        return ((r, 0.0), (0.0, r))

    @property
    def min_line_angle_rad(self) -> float:
        return math.radians(self.min_line_angle_deg)

    def replace(self, **kw) -> "FastSLAMConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = FastSLAMConfig()
