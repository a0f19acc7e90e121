"""Corner identity tracking across ticks.

Counterpart of ``fastslam_tpu/frontend/tracking.py``.  A single-frame Hough
flicker (a corner seen in one tick, missed or displaced in the next) would
become a spurious landmark append in every particle's map; this tracker sits
between the corner detector and the filter:

* a fixed-capacity track table lives in the robot frame and is ego-motion
  compensated each tick with the tick's odometry (the filter's
  rotation-XOR-translation model);
* detections within the gate of a predicted track refresh it (EMA position,
  hit count up, miss count reset) under mutual-nearest matching; unmatched
  detections open new tracks in free slots; tracks missed too many times die;
* only corners whose track has been confirmed ``min_hits`` times are emitted,
  each with a stable track id.

Every tensor keeps its shape from tick to tick, and nothing is read on the
host, so the tracker runs inside a captured CUDA graph.  JAX's dropping
scatters (``.at[K].set(mode="drop")``) scatter into a ``K + 1`` buffer whose
last entry is sliced off; the free-slot and open ranks are int32 cumulative
sums (exact, the same on every run).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class TrackState(NamedTuple):
    pos: torch.Tensor       # [K, 2] track position, robot frame
    hits: torch.Tensor      # [K] int32 confirmations
    misses: torch.Tensor    # [K] int32 consecutive misses
    track_id: torch.Tensor  # [K] int32 persistent id (-1 = free slot)
    next_id: torch.Tensor   # 0-d int32


def init_tracks(capacity: int, device: torch.device | str = "cuda",
                dtype=torch.float32) -> TrackState:
    """An empty table of ``capacity`` tracks on ``device``."""
    return TrackState(
        pos=torch.zeros((capacity, 2), dtype=dtype, device=device),
        hits=torch.zeros((capacity,), dtype=torch.int32, device=device),
        misses=torch.zeros((capacity,), dtype=torch.int32, device=device),
        track_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
    )


def _ego_compensate(pos: torch.Tensor, rotation, translation) -> torch.Tensor:
    """Where robot-frame points land after the robot rotates by ``rotation``
    or translates ``translation`` along its (new) heading:
    ``p' = R(-rotation) p - (translation, 0)``."""
    rotation = torch.as_tensor(rotation, dtype=pos.dtype, device=pos.device)
    translation = torch.as_tensor(translation, dtype=pos.dtype, device=pos.device)
    c = torch.cos(-rotation)
    s = torch.sin(-rotation)
    x = c * pos[:, 0] - s * pos[:, 1] - translation
    y = s * pos[:, 0] + c * pos[:, 1]
    return torch.stack([x, y], dim=-1)


def _drop_scatter(base: torch.Tensor, index: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``base.at[index].set(values, mode="drop")`` for ``index`` in [0, K]:
    entries aimed at K are dropped (written to a spare row, then cut)."""
    k = base.shape[0]
    spare = torch.cat([base, base[:1]], dim=0)
    values = values.to(base.dtype).expand((index.shape[0],) + base.shape[1:])
    return spare.index_put((index.to(torch.int64),), values)[:k]


def update_tracks(tracks: TrackState, corners: torch.Tensor,
                  corner_valid: torch.Tensor, rotation, translation, *,
                  gate: float = 0.4, ema: float = 1.0,
                  max_misses: int = 3) -> TrackState:
    """One tracking tick: predict, mutually match, refresh, open and kill.

    ``corners`` ``[C, 2]`` robot-frame detections with ``corner_valid``
    ``[C]``; ``rotation``/``translation`` the tick's odometry (scalars or
    0-d tensors)."""
    k = tracks.pos.shape[0]
    c = corners.shape[0]
    dev = tracks.pos.device
    alive = tracks.track_id >= 0

    pred = _ego_compensate(tracks.pos, rotation, translation)       # [K, 2]
    diff = pred[:, None, :] - corners[None, :, :]                   # [K, C, 2]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(alive[:, None] & corner_valid[None, :], d2, 1e12)

    # mutual nearest neighbours within the gate (argmin: the first minimum)
    best_c = torch.argmin(d2, dim=1)                                # [K]
    best_t = torch.argmin(d2, dim=0)                                # [C]
    t_iota = torch.arange(k, device=dev)
    best_d2 = torch.gather(d2, 1, best_c[:, None])[:, 0]
    mutual = (best_t[best_c] == t_iota) & (best_d2 < gate * gate)
    matched_t = mutual & alive                                      # [K]
    matched_c = torch.zeros(c, dtype=torch.int32, device=dev).scatter_reduce(
        0, best_c, matched_t.to(torch.int32), reduce="amax") > 0    # [C]

    # refresh matched tracks
    obs = corners[best_c]                                           # [K, 2]
    new_pos = torch.where(matched_t[:, None], (1.0 - ema) * pred + ema * obs, pred)
    hits = torch.where(matched_t, tracks.hits + 1, tracks.hits)
    misses = torch.where(matched_t, 0, tracks.misses + 1).to(torch.int32)

    # kill stale tracks
    dead = alive & (misses > max_misses)
    track_id = torch.where(dead, -1, tracks.track_id).to(torch.int32)
    hits = torch.where(dead, 0, hits).to(torch.int32)
    alive = track_id >= 0

    # open new tracks for unmatched detections at free slots
    to_open = corner_valid & ~matched_c                             # [C]
    free = ~alive                                                   # [K]
    free_rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    open_rank = torch.cumsum(to_open.to(torch.int32), 0, dtype=torch.int32) - 1
    n_free = free.to(torch.int32).sum(dtype=torch.int32)
    # the corner of open rank r goes to the r-th free slot
    slot_of_rank = _drop_scatter(torch.full((k,), k, dtype=torch.int32, device=dev),
                                 torch.where(free, free_rank, k), t_iota)
    opened = to_open & (open_rank < n_free)
    corner_slot = torch.where(
        opened, slot_of_rank[torch.clamp(open_rank, 0, k - 1).long()], k)  # [C] slot or K
    new_pos = _drop_scatter(new_pos, corner_slot, corners)
    hits = _drop_scatter(hits, corner_slot, torch.ones(1, dtype=torch.int32, device=dev))
    misses = _drop_scatter(misses, corner_slot,
                           torch.zeros(1, dtype=torch.int32, device=dev))
    new_ids = tracks.next_id + open_rank
    track_id = _drop_scatter(track_id, corner_slot, torch.where(opened, new_ids, -1))
    next_id = tracks.next_id + opened.to(torch.int32).sum(dtype=torch.int32)
    return TrackState(pos=new_pos, hits=hits, misses=misses, track_id=track_id,
                      next_id=next_id)


def stable_corners(tracks: TrackState, *, min_hits: int = 2
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Confirmed corners only: ``(pos [K, 2], ids [K], valid [K])``, the
    robot-frame positions of tracks seen at least ``min_hits`` times and not
    currently missing."""
    ok = (tracks.track_id >= 0) & (tracks.hits >= min_hits) & (tracks.misses == 0)
    return tracks.pos, tracks.track_id, ok
