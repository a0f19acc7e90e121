"""Collectives of the particle mesh: over the shards one process holds, and
over a ``torch.distributed`` process group.

Under ``shard_map`` and GSPMD the JAX package runs one program per device,
and XLA inserts the collectives between them.  The port runs one Python
program per process that holds its shards' tensors as a list in shard order
and loops over it, so each collective is an operation on that list:

* :func:`all_gather`: concatenation in shard order;
* :func:`psum`: the sum of per-shard integers or flags, or of float
  partials, added in shard order;
* :func:`ppermute`: a shift along the ring, each shard's tensor copied to
  its neighbour's device;
* the shard index is the controller's loop variable; :func:`shard_range`
  gives the global particles that shard holds.

With ``group`` (a process group, see ``parallel/multihost.py``) every process
passes its own shards and the global shards are every process's list in rank
order, all processes holding the same count.  :func:`all_gather` then gathers
the processes' concatenations in rank order, so every process gets the same
tensor; :func:`psum` gathers the partials and adds them in global shard order
with no ``all_reduce``, so S shards over N processes equal S shards in one
process bit for bit; :func:`ppermute` sends the shards whose ring neighbour
lies in another process point to point.  gloo has no CUDA form of these
collectives (it has of broadcast and all-reduce only), so under gloo a CUDA
tensor stages through host memory: copied to the host, exchanged there, and
copied back to its device.  Any other backend is handed the tensors as they
are.  :data:`TRAFFIC` counts the calls over a group, the bytes this process
received through it, and the host seconds spent in them (the staging copies
included; the device is synchronised before the clock starts, so its earlier
work is not counted).

:func:`tally` records every collective issued inside it, in one process or
over a group, with the bytes of its result as one shard holds it (the way
``scripts/collective_bytes.py`` reckons an HLO result type): an
:func:`all_gather` the whole concatenation, a :func:`psum` one sum (an
integer sum 8 bytes), a :func:`ppermute` the one tensor each shard receives.
Beside those it records the re-split of a gathered state into shards
(``parallel/mesh.py:shard_state``, op ``split``, each shard's slice; XLA
slices locally and counts none) and the ring exchange kernel's two ring
shifts of each shard's block (``core/cuda_kernels/ring.py:ring_halo_exchange``
and its cross-process form).  :func:`site` names the part of a step an op
belongs to (the whole-state gather, the halo, the ring).

Float reductions over particles (weight normalization, Neff, the argmax
pose) gather the ``[P]`` vector and call the single-device function, so S
shards agree with one shard bit for bit.  The JAX package reduces within
each shard and combines the partial results, which agrees with one device
only within rounding.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

# calls over a process group, bytes this process received through it, and
# host seconds spent in them (the host clock, staging copies included)
TRAFFIC = {"calls": 0, "bytes": 0, "seconds": 0.0}
# the open tallies (lists of op records) and the stack of site names
_TALLIES: List[list] = []
_SITES: List[str] = []


@contextlib.contextmanager
def tally() -> Iterator[list]:
    """Record the collectives issued inside: yields a list that gains one
    ``{"op", "bytes", "site"}`` per op (``op`` one of ``all_gather``,
    ``psum``, ``ppermute``, ``split``; ``bytes`` the result one shard holds;
    ``site`` the innermost :func:`site`, or None)."""
    ops: list = []
    _TALLIES.append(ops)
    try:
        yield ops
    finally:
        _TALLIES.remove(ops)


@contextlib.contextmanager
def site(name: str) -> Iterator[None]:
    """Name the part of a step the collectives inside belong to."""
    _SITES.append(name)
    try:
        yield
    finally:
        _SITES.pop()


def record(op: str, nbytes: int) -> None:
    """Add one op of ``nbytes`` result bytes to every open tally."""
    for ops in _TALLIES:
        ops.append({"op": op, "bytes": int(nbytes), "site": _SITES[-1] if _SITES else None})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def shard_range(shard: int, p_local: int) -> slice:
    """The global particle indices of shard ``shard`` (``p_local`` each)."""
    return slice(shard * p_local, (shard + 1) * p_local)


def _on_host(t: torch.Tensor, group) -> bool:
    """Whether ``t`` stages through host memory: a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's backend takes it."""
    return t.cpu() if _on_host(t, group) else t.contiguous()


def _start(t: torch.Tensor, group) -> float:
    """The host clock at the start of a collective, after the device of a
    staged tensor has finished its earlier work."""
    if _on_host(t, group):
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def _count(start: float, nbytes: int) -> None:
    TRAFFIC["calls"] += 1
    TRAFFIC["bytes"] += nbytes
    TRAFFIC["seconds"] += time.perf_counter() - start


def _gather_processes(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every process's ``t`` (the same shape on each), in rank order, on
    ``t``'s device."""
    start = _start(t, group)
    staged = _staged(t, group)
    parts = [torch.empty_like(staged) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, staged, group=group)
    out = [p.to(t.device) for p in parts]
    _count(start, staged.numel() * staged.element_size() * (len(parts) - 1))
    return out


def all_gather(tensors: Sequence[torch.Tensor], dim: int = 0, group=None) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` in shard order, on the
    first shard's device; with ``group``, every process's shards."""
    device = tensors[0].device
    local = torch.cat([t.to(device) for t in tensors], dim=dim)
    out = local if group is None else torch.cat(_gather_processes(local, group), dim=dim)
    record("all_gather", _nbytes(out))
    return out


def psum(values: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """The sum of the shards' tensors, on the first shard's device; with
    ``group``, of every process's shards.

    Integers or flags (0-d tensors) sum in int64.  Float partials (any
    shape, one per shard) add in shard order, ``((v0 + v1) + v2) + ...``,
    so a run repeats bit for bit and N processes agree with one; S shards
    agree with one shard within rounding, as the JAX package's ``psum`` over
    the map axis does."""
    device = values[0].device
    floats = values[0].is_floating_point()
    if group is not None:
        local = torch.stack([v.to(device) if floats else v.to(device, torch.int64)
                             for v in values])
        values = list(torch.cat(_gather_processes(local, group)))
    if floats:
        total = values[0]
        for v in values[1:]:
            total = total + v.to(device)
    else:
        total = torch.stack([v.to(device, torch.int64) for v in values]).sum()
    record("psum", _nbytes(total))
    return total


def ppermute(tensors: Sequence[torch.Tensor], shift: int,
             devices: Sequence[torch.device], group=None) -> List[torch.Tensor]:
    """A ring shift: shard ``i`` receives a copy of shard ``i - shift``'s
    tensor (mod S) on its device.  ``shift=1`` gives each shard its left
    neighbour's tensor, ``shift=-1`` its right neighbour's.  With ``group``
    the ring runs over every process's shards (the same shape on each), and
    a tensor whose receiver lies in another process goes there point to
    point."""
    n_local = len(tensors)
    record("ppermute", _nbytes(tensors[0]))
    if group is None:
        return [tensors[(i - shift) % n_local].to(devices[i], copy=True)
                for i in range(n_local)]
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    n, first = n_local * world, rank * n_local
    owner = lambda g: dist.get_global_rank(group, g // n_local)
    start = _start(tensors[0], group)
    out: List[Optional[torch.Tensor]] = [None] * n_local
    ops, received = [], []
    for i in range(n_local):
        src = (first + i - shift) % n
        if first <= src < first + n_local:
            out[i] = tensors[src - first].to(devices[i], copy=True)
        else:
            buf = torch.empty_like(tensors[i],
                                   device="cpu" if _on_host(tensors[i], group) else None)
            ops.append(dist.P2POp(dist.irecv, buf, owner(src), group, tag=first + i))
            received.append((i, buf))
    for j in range(n_local):
        dst = (first + j + shift) % n
        if not first <= dst < first + n_local:
            ops.append(dist.P2POp(dist.isend, _staged(tensors[j], group), owner(dst), group,
                                  tag=dst))
    if not ops:
        return out
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for i, buf in received:
        out[i] = buf.to(devices[i], copy=True)
    _count(start, sum(b.numel() * b.element_size() for _, b in received))
    return out
