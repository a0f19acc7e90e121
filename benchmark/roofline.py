"""The card's published peaks and the least time of a filter chunk.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit.  The
operation counts per slot, measurement and particle are assumed: counted by
hand from the plain reference's arithmetic (``reference/filter.py``), the
same constants the repository's smoke script uses.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# assumed operation counts: per occupied slot of one association pass; per
# measurement and particle for observation, EKF and weight; per measurement
# and particle for the fs2 proposal's accumulation; per particle for the
# fs2 solve and sample
ASSOC_OPS_PER_SLOT = 20
EKF_OPS = 120
PROPOSAL_OPS = 100
SAMPLE_OPS = 80
PRODUCTION_PLANES = 5


def bound_s(nbytes: float, ops: float) -> float:
    """The larger of bytes over the memory rate and operations over the
    float32 rate."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)


def chunk_bound_s(*, p: int, c: int, measured: int, occupied: int, written: int,
                  resampled: bool, fs2: bool) -> float:
    """Least seconds of one chunk of C ticks at P particles with
    ``measured`` valid measurements per tick: the update reads the five
    planes over the ``occupied`` slots (summed over particles) once and
    writes the ``written`` slots once, reads and writes the per-particle
    rows (poses, cos/sin yaw, weights, counts), reads the draws and writes
    the trajectory; the association scans the occupied slots, a lower bound
    since the maps grow inside the chunk.  The boundary reads and writes the
    weights and, where it resamples, gathers the occupied planes and the
    rows once."""
    rows = (3 + 2 + 2 + 2) * p * 4
    draws = (3 if fs2 else 2) * c * p * 4
    traj = 4 * c * p * 4
    planes = PRODUCTION_PLANES * 4 * (occupied + written)
    boundary = 2 * p * 4
    if resampled:
        boundary += 2 * (PRODUCTION_PLANES * 4 * occupied + 5 * p * 4)
    if fs2:
        ops = c * (measured * (2 * ASSOC_OPS_PER_SLOT * occupied + (PROPOSAL_OPS + EKF_OPS) * p)
                   + SAMPLE_OPS * p)
    else:
        ops = c * measured * (ASSOC_OPS_PER_SLOT * occupied + EKF_OPS * p)
    return bound_s(planes + rows + draws + traj + boundary, ops)
