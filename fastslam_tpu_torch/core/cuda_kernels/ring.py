"""The ring halo exchange of the distributed resampler and its plain
versions (``csrc/ring_halo.cu``).

:func:`ring_halo_exchange`: every shard's packed particle block to both
ring neighbours, for a ring of shards on one card, one thread per 16
bytes.  Its cross-process form (:func:`ring_halo_exchange_peers`), for a
ring over the processes of a group: each process writes into its neighbour
processes' receive buffers through CUDA IPC mappings (:class:`PeerRing`)
into one of two receive buffer sets by call parity, every wait on another
process held by the stream's front end.
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from fastslam_tpu_torch.core import _build
from fastslam_tpu_torch.core.cuda_kernels._launch import launch, require_cuda

# the most shards one exchange launch takes (csrc/ring_halo.cu RING_MAX_SHARDS)
RING_MAX_SHARDS = 64
# the cross-process exchange (csrc/ring_halo.cu PeerFlag): the 64-bit words at
# the head of each process's allocation, the bytes kept for them, the
# alignment of each receive buffer after them, the receive buffer sets (call
# e writes set e % 2), and how long a call may wait for its neighbours
# before it is released and raises
PEER_FLAGS = ("entered_from_left", "entered_from_right", "delivered_from_left",
              "delivered_from_right", "blocks_done", "cancelled")
PEER_FLAG_BYTES = 256
PEER_ALIGN = 256
PEER_SETS = 2
PEER_TIMEOUT_S = 30.0
# what a ring counts of its calls (PeerRing.stats): the calls, those whose wait
# (a) found its words already set, the longest wait (a), and the device ms
# summed over the calls of wait (a), the copy and wait (c)
PEER_STATS = ("calls", "entered_met", "entered_max_ms", "entered_ms", "copy_ms", "delivered_ms")


def ring_halo_exchange_ref(blocks):
    """Plain PyTorch version of :func:`ring_halo_exchange` (same contract):
    a copy of each neighbour's block, shard by shard."""
    _check_ring_blocks(blocks)
    s = len(blocks)
    lefts = [blocks[(i - 1) % s].clone() for i in range(s)]
    rights = [blocks[(i + 1) % s].clone() for i in range(s)]
    return lefts, rights


def ring_halo_exchange_peers_ref(blocks, group):
    """Plain version of :func:`ring_halo_exchange_peers` (same contract): two
    ring shifts of ``parallel/collectives.py:ppermute`` over ``group``, the
    blocks bound for another process sent point to point through the
    group's backend (with ``group=None``, the shards of this process)."""
    from fastslam_tpu_torch.parallel.collectives import ppermute

    _check_ring_blocks(blocks)
    devices = [b.device for b in blocks]
    return ppermute(blocks, 1, devices, group), ppermute(blocks, -1, devices, group)


def _check_ring_blocks(blocks):
    if not blocks or blocks[0].dim() != 2:
        raise ValueError("a ring needs at least one [P_local, D] block")
    first = blocks[0]
    for b in blocks:
        if (b.shape != first.shape or b.dtype != torch.float32
                or b.device != first.device):
            raise ValueError(f"ring blocks must be float32 {tuple(first.shape)} on "
                             f"{first.device}, got {b.dtype} {tuple(b.shape)} on {b.device}")


def ring_halo_exchange(blocks):
    """Every shard's block to both ring neighbours, for a ring of shards on
    one card, in one launch.

    Args:
      blocks: S float32 ``[P_local, D]`` blocks, one per shard in ring order,
      contiguous and on one device (``D = 3 + 1 + 2L + 4L + 1`` for the packed
      particle block of ``parallel/resample.py:pack_particle_block``).

    Returns ``(lefts, rights)``: lists of S new blocks, ``lefts[s]`` the
    block of shard ``s - 1`` and ``rights[s]`` that of shard ``s + 1``
    (mod S).  At S = 1 both are copies of the one block.  An open
    ``parallel/collectives.py:tally`` records the call as two ring shifts of
    one block, as the TPU kernel's two remote copies.
    """
    blocks = list(blocks)
    _record_ring_shifts(blocks)
    if blocks and blocks[0].device.type == "cpu":
        return ring_halo_exchange_ref(blocks)
    device, s, n = _exchange_blocks(blocks)
    lefts = [torch.empty_like(b) for b in blocks]
    rights = [torch.empty_like(b) for b in blocks]
    pointers = lambda ts: (ctypes.c_void_p * s)(*(t.data_ptr() for t in ts))
    src, left, right = pointers(blocks), pointers(lefts), pointers(rights)
    launch(
        "ring_halo_exchange", device,
        *(ctypes.c_void_p(ctypes.addressof(a)) for a in (src, left, right)),
        ctypes.c_int(s), ctypes.c_int(n),
    )
    return lefts, rights


def _record_ring_shifts(blocks):
    """The exchange's two ring shifts of one block each, in an open tally."""
    from fastslam_tpu_torch.parallel.collectives import record

    if blocks:
        for _ in range(2):
            record("ppermute", blocks[0].numel() * blocks[0].element_size())


def _exchange_blocks(blocks):
    """``(device, S, floats per block)`` of blocks both exchange kernels
    take, or raise."""
    _check_ring_blocks(blocks)
    device = require_cuda(*blocks)
    s, n = len(blocks), blocks[0].numel()
    if s > RING_MAX_SHARDS:
        raise ValueError(f"one exchange takes at most {RING_MAX_SHARDS} shards, got {s}")
    if n >= 2 ** 31:
        raise ValueError(f"a block of {n} floats is too large for one exchange")
    if any(b.data_ptr() % 16 for b in blocks):
        raise ValueError("the exchange kernel takes blocks aligned to 16 bytes")
    return device, s, n


class PeerRoute(NamedTuple):
    """Where one write of the cross-process exchange lands: the process (its
    rank in the group), its local shard, the receive buffer and the buffer
    set (call e writes and reads set e % 2)."""

    rank: int
    local: int
    buffer: str     # "left" or "right"
    parity: int = 0


def ring_peer_routes(rank: int, world: int, n_local: int,
                     parity: int = 0) -> List[Tuple[PeerRoute, PeerRoute]]:
    """For each of process ``rank``'s ``n_local`` shards (global shard
    ``g = rank * n_local + k``), its block's two writes into buffer set
    ``parity``: into the left buffer of shard ``g + 1`` and into the right
    buffer of shard ``g - 1``, mod the ring's ``world * n_local`` shards, as
    ``ppermute`` by +1 and -1 routes them."""
    n = world * n_local
    out = []
    for k in range(n_local):
        g = rank * n_local + k
        to_left, to_right = (g + 1) % n, (g - 1) % n
        out.append((PeerRoute(to_left // n_local, to_left % n_local, "left", parity),
                    PeerRoute(to_right // n_local, to_right % n_local, "right", parity)))
    return out


def ring_peer_signals(rank: int, world: int) -> Tuple[Tuple[int, int], ...]:
    """The four flag words process ``rank`` stores into, as ``(process,
    word)``: entered into its right neighbour process (that one's
    ``entered_from_left``) and into its left one, then delivered likewise.
    With two processes both neighbours are the one other process, whose
    words still tell the two directions apart."""
    right, left = (rank + 1) % world, (rank - 1) % world
    word = PEER_FLAGS.index
    return ((right, word("entered_from_left")), (left, word("entered_from_right")),
            (right, word("delivered_from_left")), (left, word("delivered_from_right")))


class PeerCall(NamedTuple):
    """One call of the cross-process exchange in one process, in the order
    its wrapper enqueues it on the stream (:func:`ring_peer_schedule`).
    Waits are ``(word of this process's region, least value)``; stores are
    ``(process, word, value)``."""

    epoch: int
    parity: int                                      # the buffer set written and read
    wait_entered: Tuple[Tuple[int, int], ...]        # (a)
    entered: Tuple[Tuple[int, int, int], ...]        # (b), before the copy
    writes: Tuple[Tuple[PeerRoute, PeerRoute], ...]  # (b): each local block's two writes
    delivered: Tuple[Tuple[int, int, int], ...]      # (b), after every write
    wait_delivered: Tuple[Tuple[int, int], ...]      # (c)
    reads: Tuple[Tuple[PeerRoute, PeerRoute], ...]   # the halos returned: (left, right) per shard


def ring_peer_schedule(rank: int, world: int, n_local: int, epoch: int) -> PeerCall:
    """Call ``epoch`` (1, 2, ...) of the cross-process exchange in process
    ``rank`` of ``world``, each holding ``n_local`` shards: (a) wait until
    both neighbours' entered words in this process's region reach ``epoch -
    1``; (b) the kernel stores entered = ``epoch`` into both neighbours,
    writes each local block into buffer set ``epoch % 2`` of its two
    receivers, and after every write stores delivered = ``epoch`` into both
    neighbours; (c) wait until both neighbours' delivered words reach
    ``epoch``.  The halos are then this process's buffers of that set."""
    if epoch < 1:
        raise ValueError(f"calls count from 1, got {epoch}")
    parity = epoch % PEER_SETS
    word = PEER_FLAGS.index
    signals = ring_peer_signals(rank, world)
    return PeerCall(
        epoch=epoch, parity=parity,
        wait_entered=((word("entered_from_left"), epoch - 1),
                      (word("entered_from_right"), epoch - 1)),
        entered=tuple((p, w, epoch) for p, w in signals[:2]),
        writes=tuple(ring_peer_routes(rank, world, n_local, parity)),
        delivered=tuple((p, w, epoch) for p, w in signals[2:]),
        wait_delivered=((word("delivered_from_left"), epoch),
                        (word("delivered_from_right"), epoch)),
        reads=tuple((PeerRoute(rank, k, "left", parity), PeerRoute(rank, k, "right", parity))
                    for k in range(n_local)))


def ring_peer_offset(local: int, buffer: str, block_bytes: int, parity: int = 0) -> int:
    """Byte offset of local shard ``local``'s ``buffer`` (``"left"`` or
    ``"right"``) of buffer set ``parity`` in a process's allocation: the
    flag region, then for each local shard its left and right buffers of
    set 0 and of set 1, each starting on ``PEER_ALIGN`` bytes.
    ``ring_peer_offset(n_local, "left", ...)`` is the allocation's size."""
    stride = -(-block_bytes // PEER_ALIGN) * PEER_ALIGN
    return PEER_FLAG_BYTES + (2 * (PEER_SETS * local + parity) + (buffer == "right")) * stride


class _DeviceArray:
    """Device memory that ``torch.as_tensor`` wraps without a copy, through
    the CUDA array interface: float32, or another ``typestr``."""

    def __init__(self, ptr: int, shape, typestr: str = "<f4"):
        self.__cuda_array_interface__ = {"shape": tuple(shape), "typestr": typestr,
                                         "data": (ptr, False), "version": 2}


class PeerRing:
    """The buffers and flags of one ring of :func:`ring_halo_exchange_peers`.

    Made once per (group, device, local shards, block shape), a collective
    over ``group``: this process checks that the card takes 64-bit stream
    memory operations (``csrc/ring_halo.cu:ring_peers_stream_ops``), on
    which every wait is built, allocates its flag region and both sets of
    the left and right receive buffers of each local shard in one
    ``cudaMalloc`` (``ring_peers_alloc``; an IPC handle covers a whole
    allocation, so not through torch's caching allocator), the 64-byte IPC
    handles are all-gathered over the group as a uint8 tensor, and each
    neighbour process's allocation is mapped (``ring_peers_open``).  A
    refused card or a failed open raises in every process.  It enqueues a
    call's waits (:meth:`begin`, :meth:`end`), gives its launch's pointer
    tables (:meth:`tables`) and its halos (:meth:`halos`: views of the
    receive buffers, valid until :meth:`close`), and holds the call count
    (``epoch``) and ``stats`` (``PEER_STATS``, from events around each
    step)."""

    def __init__(self, group, device: torch.device, n_local: int, shape):
        from fastslam_tpu_torch.parallel.collectives import all_gather

        self.group, self.device = group, device
        self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
        self.epoch, self.failed, self.base = 0, None, None
        self.mapped: Dict[int, int] = {}
        self.stats = dict.fromkeys(PEER_STATS, 0)
        lib = _build.load()
        self.nbytes = math.prod(shape) * 4
        handle = (ctypes.c_ubyte * 64)()
        error = self._stream_ops_error(lib)
        if error is None:
            base = ctypes.c_void_p()
            self._call(lib.ring_peers_alloc,
                       ctypes.c_longlong(ring_peer_offset(n_local, "left", self.nbytes)),
                       ctypes.c_void_p(ctypes.addressof(base)),
                       ctypes.c_void_p(ctypes.addressof(handle)))
            self.base = base.value
        handles = all_gather([torch.tensor(list(bytes(handle)), dtype=torch.uint8)],
                             group=group).view(self.world, 64)
        for peer in sorted({(self.rank - 1) % self.world, (self.rank + 1) % self.world}
                           - {self.rank}):
            if error is not None:
                break
            theirs = (ctypes.c_ubyte * 64)(*handles[peer].tolist())
            ptr = ctypes.c_void_p()
            rc = lib.ring_peers_open(self._index, ctypes.c_void_p(ctypes.addressof(theirs)),
                                     ctypes.c_void_p(ctypes.addressof(ptr)))
            if rc:
                error = (f"process {self.rank} could not map process {peer}'s ring buffers "
                         f"(cudaIpcOpenMemHandle): {_build.error_string(rc)}")
                break
            self.mapped[peer] = ptr.value
        errors = [None] * self.world
        dist.all_gather_object(errors, error, group=group)
        if any(errors):
            self.close()
            raise RuntimeError("; ".join(e for e in errors if e))
        self._bases = {self.rank: self.base, **self.mapped}
        self._halos = {(k, side, parity): torch.as_tensor(_DeviceArray(
            self.base + ring_peer_offset(k, side, self.nbytes, parity), shape), device=device)
            for k in range(n_local) for side in ("left", "right") for parity in range(PEER_SETS)}
        self._start, self._entered, self._copied, self._done = (
            torch.cuda.Event(enable_timing=True) for _ in range(4))
        # the words wait (a) reads, and their values as the stream reaches it
        self._entered_words = torch.as_tensor(_DeviceArray(self.base, (2,), "<i8"), device=device)
        self._seen = torch.zeros(2, dtype=torch.int64, pin_memory=True)
        self._release = torch.cuda.Stream(device, priority=-1)
        self._pending: Optional[PeerCall] = None

    @property
    def _index(self) -> ctypes.c_int:
        return ctypes.c_int(self.device.index)

    def _call(self, fn, *args):
        rc = fn(self._index, *args)
        if rc:
            raise RuntimeError(f"{fn.__name__} failed: {_build.error_string(rc)}")

    def _stream_ops_error(self, lib) -> Optional[str]:
        supported = ctypes.c_int()
        rc = lib.ring_peers_stream_ops(self._index, ctypes.c_void_p(ctypes.addressof(supported)))
        if rc:
            return (f"process {self.rank} could not resolve the driver's stream memory "
                    f"operations: {_build.error_string(rc)}")
        if not supported.value:
            return (f"process {self.rank}: {torch.cuda.get_device_name(self.device)} does not "
                    f"take 64-bit stream memory operations "
                    f"(CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS is 0), on which every "
                    f"wait of the exchange is built")
        return None

    def _enqueue(self, fn, words, stream) -> None:
        """``ring_peers_wait`` or ``ring_peers_write`` of ``[(word of this
        process's region, value)]`` on ``stream``."""
        ptrs = (ctypes.c_void_p * len(words))(*(self.base + 8 * w for w, _ in words))
        values = (ctypes.c_longlong * len(words))(*(v for _, v in words))
        self._call(fn, ctypes.c_void_p(ctypes.addressof(ptrs)),
                   ctypes.c_void_p(ctypes.addressof(values)), ctypes.c_int(len(words)),
                   ctypes.c_void_p(stream.cuda_stream))

    def begin(self, call: PeerCall, stream) -> None:
        """Enqueue on ``stream`` a copy of the words ``call``'s wait (a)
        reads (the words only grow, so if the copy finds them set, the wait
        finds them set), then the wait between the events that time it."""
        self._seen.copy_(self._entered_words, non_blocking=True)
        self._start.record(stream)
        self._enqueue(_build.load().ring_peers_wait, call.wait_entered, stream)
        self._entered.record(stream)

    def tables(self, call: PeerCall):
        """The pointer tables of ``call``'s launch: where each local block
        goes (to the left buffer of shard g + 1, to the right buffer of shard
        g - 1) and the four words it stores into (entered, then delivered)."""
        table = lambda ptrs: (ctypes.c_void_p * len(ptrs))(*ptrs)
        at = lambda r: self._bases[r.rank] + ring_peer_offset(r.local, r.buffer, self.nbytes,
                                                              r.parity)
        return (table([at(to_left) for to_left, _ in call.writes]),
                table([at(to_right) for _, to_right in call.writes]),
                table([self._bases[p] + 8 * w for p, w, _ in call.entered + call.delivered]))

    def end(self, call: PeerCall, stream) -> None:
        """Enqueue, after ``call``'s launch, an event, the wait (c) and the
        event after it on ``stream``."""
        self._copied.record(stream)
        self._enqueue(_build.load().ring_peers_wait, call.wait_delivered, stream)
        self._done.record(stream)
        self._pending = call

    def halos(self, call: PeerCall):
        """``(lefts, rights)``: this process's receive buffers that ``call``
        reads, one of each per local shard."""
        return ([self._halos[r.local, r.buffer, r.parity] for r, _ in call.reads],
                [self._halos[r.local, r.buffer, r.parity] for _, r in call.reads])

    def check(self) -> None:
        """Wait for the last call's event after (c), polling it for
        ``PEER_TIMEOUT_S`` seconds, then count its waits in ``stats``.  On
        expiry release the stream (:meth:`_release_stream`), refuse the ring
        from here on and raise."""
        timeout = PEER_TIMEOUT_S
        call, start = self._pending, time.monotonic()
        while not self._done.query():
            waited = time.monotonic() - start
            if waited > timeout:
                wait = "delivered" if self._entered.query() else "entered"
                self.failed = (f"process {self.rank} of {self.world}: call {call.epoch} waited "
                               f"{timeout:g} s for its neighbours' {wait} words")
                if not self._release_stream(call):
                    self.failed += "; its stream is still blocked"
                raise RuntimeError(f"cross-process ring exchange: {self.failed}")
            # yield for the first 10 ms (an exchange takes a few), then sleep
            time.sleep(0.0 if waited < 0.01 else 1e-4)
        entered_ms = self._start.elapsed_time(self._entered)
        self.stats["calls"] += 1
        self.stats["entered_met"] += all(
            seen >= value for seen, (_, value) in zip(self._seen.tolist(), call.wait_entered))
        self.stats["entered_max_ms"] = max(self.stats["entered_max_ms"], entered_ms)
        self.stats["entered_ms"] += entered_ms
        self.stats["copy_ms"] += self._entered.elapsed_time(self._copied)
        self.stats["delivered_ms"] += self._copied.elapsed_time(self._done)

    def _release_stream(self, call: PeerCall) -> bool:
        """Write the cancel word (the kernel of a call released in (a)
        copies nothing) and every word ``call`` waits on into this process's
        region from a second stream, until the call's stream passes its
        event after (c): up to three tries of 5 s, since a late neighbour may
        store a smaller value in between.  Whether the stream passed."""
        words = ((PEER_FLAGS.index("cancelled"), call.epoch),) + call.wait_entered \
            + call.wait_delivered
        for _ in range(3):
            self._enqueue(_build.load().ring_peers_write, words, self._release)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if self._done.query():
                    return True
                time.sleep(1e-3)
        return False

    def close(self) -> None:
        """Unmap the neighbours' buffers and free this process's: a
        collective over the group, after every process's last exchange."""
        lib = _build.load()
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)      # no process still runs an exchange
        for ptr in self.mapped.values():
            self._call(lib.ring_peers_close, ctypes.c_void_p(ptr))
        dist.barrier(group=self.group)      # no process still maps my allocation
        if self.base is not None:
            self._call(lib.ring_peers_free, ctypes.c_void_p(self.base))
        self.mapped, self._halos, self.base = {}, {}, None
        self.failed = "closed"


_PEER_RINGS: Dict[tuple, PeerRing] = {}


def peer_ring(group, device: torch.device, n_local: int, shape) -> PeerRing:
    """The cached :class:`PeerRing` of ``group`` for ``n_local`` blocks of
    ``shape`` on ``device``, made at first use (a collective: every process
    reaches it at the same call)."""
    key = (group, device, n_local, tuple(shape))
    ring = _PEER_RINGS.get(key)
    if ring is None:
        ring = _PEER_RINGS[key] = PeerRing(group, device, n_local, shape)
    if ring.failed:
        raise RuntimeError(f"cross-process ring exchange: this ring failed earlier: "
                           f"{ring.failed}")
    return ring


def peer_ring_stats(group=None) -> dict:
    """The waits of the cached rings over ``group`` (every group's with
    None), summed over the rings (the longest wait in (a) over them): see
    :class:`PeerRing`."""
    out = dict.fromkeys(PEER_STATS, 0)
    for key, ring in _PEER_RINGS.items():
        if group is None or key[0] is group:
            for k, v in ring.stats.items():
                out[k] = max(out[k], v) if k == "entered_max_ms" else out[k] + v
    return out


def close_peer_rings(group=None) -> None:
    """Free the cached rings over ``group`` (every group's with None), in
    the order they were made.  A collective: every process of each group
    calls it, before the group is destroyed."""
    for key in [k for k in _PEER_RINGS if group is None or k[0] is group]:
        _PEER_RINGS.pop(key).close()


def ring_halo_exchange_peers(blocks, group):
    """Every shard's block to both ring neighbours, for a ring over the
    processes of ``group``: one launch per process per call.

    Args:
      blocks: this process's S_local float32 ``[P_local, D]`` blocks, in
        ring order, contiguous and on one device; the ring's global shards
        are every process's blocks in rank order.  Every process passes as
        many blocks of one shape, and calls this in the same order.
      group: the ``torch.distributed`` process group of the ring.

    Returns ``(lefts, rights)`` as :func:`ring_halo_exchange`: ``lefts[k]``
    the block of global shard ``g - 1`` and ``rights[k]`` that of shard
    ``g + 1`` (mod S), for ``g`` local shard ``k``'s global index.  On the
    card they are the ring's receive buffers of the call's set
    (:class:`PeerRing`): valid until the next exchange on the same ring, so
    the caller consumes them before that, on the same stream.  The call
    enqueues :func:`ring_peer_schedule`'s waits on the current stream around
    its one launch.  A refused card, a failed map or launch, or a wait past
    ``PEER_TIMEOUT_S`` raises, and the ring is refused from then on.  An
    open ``parallel/collectives.py:tally`` records the call as two ring
    shifts of one block (on the CPU, the plain version's two ``ppermute``
    calls record themselves).
    """
    blocks = list(blocks)
    if blocks and blocks[0].device.type == "cpu":
        return ring_halo_exchange_peers_ref(blocks, group)
    _record_ring_shifts(blocks)
    device, s, n = _exchange_blocks(blocks)
    ring = peer_ring(group, device, s, tuple(blocks[0].shape))
    call = ring_peer_schedule(ring.rank, ring.world, s, ring.epoch + 1)
    ring.epoch = call.epoch
    stream = torch.cuda.current_stream(device)
    # the pointer tables stay referenced here until the launch has read them
    tables = ((ctypes.c_void_p * s)(*(b.data_ptr() for b in blocks)), *ring.tables(call))
    try:
        ring.begin(call, stream)                                          # (a)
        launch(                                                           # (b)
            "ring_halo_exchange_peers", device,
            *(ctypes.c_void_p(ctypes.addressof(a)) for a in tables),
            ctypes.c_void_p(ring.base), ctypes.c_int(s), ctypes.c_int(n),
            ctypes.c_longlong(call.epoch),
        )
        ring.end(call, stream)                                            # (c)
    except RuntimeError as e:
        ring.failed = str(e)
        raise
    ring.check()
    return ring.halos(call)
