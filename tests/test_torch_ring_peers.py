"""The routing and the protocol of the cross-process ring exchange, checked
without a GPU.

``core/cuda_kernels/ring.py:ring_peer_routes`` gives, for each local shard of a
process, the process, local shard, receive buffer and buffer set that each
of its block's two writes goes to; the kernel (``csrc/ring_halo.cu``) writes
through exactly those pointers.  It must route as the plain exchange does:
``parallel/collectives.py:ppermute`` by +1 (the left halos) and -1 (the
right halos) over the group.  ``ppermute`` runs here in each simulated rank
of a group with a stand-in for ``torch.distributed``, which records every
point-to-point send and delivers it to the matching receive.

``ring_peer_schedule`` gives one call's waits, stores, writes and reads.
A model runs the schedules of several simulated processes over many calls,
in interleavings that ``hypothesis`` draws, and checks that no write lands
in a buffer set its owner is still reading, that every wait is met in the
end, and that every halo is the block ``ppermute`` routes there.  Beside
them: the wrapper enqueues exactly the schedule, the flag words each
process signals, the layout of a process's allocation, and the probe of the
ring across processes, on the CPU.
"""

import ctypes
import json
import random
import subprocess
import sys

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.core.cuda_kernels import ring as ring_kernels
from fastslam_tpu_torch.parallel import collectives

torch.set_num_threads(1)

LAYOUTS = [(2, 1), (2, 2), (2, 4), (3, 2), (4, 1)]   # (processes, shards each)


class FakeDist:
    """Enough of ``torch.distributed`` for ``ppermute`` over a group: one
    simulated rank at a time; sends are recorded by (source, destination,
    tag) and, once ``deliver`` is set, handed to the matching receives."""

    class P2POp:
        def __init__(self, op, tensor, peer, group, tag):
            self.op, self.tensor, self.peer, self.tag = op, tensor, peer, tag

    def __init__(self, world):
        self.world, self.rank, self.sent, self.deliver = world, 0, {}, False

    def get_rank(self, group):
        return self.rank

    def get_world_size(self, group):
        return self.world

    def get_global_rank(self, group, rank):
        return rank

    def isend(self):
        pass

    def irecv(self):
        pass

    def batch_isend_irecv(self, ops):
        for op in ops:
            if op.op == self.isend:   # bound methods: equal, not identical
                self.sent[(self.rank, op.peer, op.tag)] = op.tensor.clone()
            elif self.deliver:
                op.tensor.copy_(self.sent[(op.peer, self.rank, op.tag)])
        return []


def ppermute_sources(monkeypatch, world, n_local, shift):
    """``{receiving global shard: sending global shard}`` of
    ``ppermute(..., shift)`` over ``world`` simulated processes, each
    shard's tensor holding its global index."""
    fake = FakeDist(world)
    monkeypatch.setattr(collectives, "dist", fake)
    tensors = lambda r: [torch.tensor([float(r * n_local + k)]) for k in range(n_local)]
    devices = [torch.device("cpu")] * n_local
    for deliver in (False, True):      # every rank's sends, then every rank's receives
        fake.deliver = deliver
        outs = []
        for r in range(world):
            fake.rank = r
            outs.append(collectives.ppermute(tensors(r), shift, devices, group="group"))
    return {r * n_local + k: int(t.item()) for r, out in enumerate(outs)
            for k, t in enumerate(out)}


@pytest.mark.parametrize("world,n_local", LAYOUTS)
def test_routes_match_ppermute(monkeypatch, world, n_local):
    lefts = ppermute_sources(monkeypatch, world, n_local, 1)     # left_g = block_{g-1}
    rights = ppermute_sources(monkeypatch, world, n_local, -1)   # right_g = block_{g+1}
    n = world * n_local
    assert sorted(lefts) == sorted(rights) == list(range(n))
    for rank in range(world):
        routes = cuda_kernels.ring_peer_routes(rank, world, n_local)
        assert len(routes) == n_local
        for k, (to_left, to_right) in enumerate(routes):
            g = rank * n_local + k
            assert to_left.buffer == "left" and to_right.buffer == "right"
            for route, sources in ((to_left, lefts), (to_right, rights)):
                assert 0 <= route.rank < world and 0 <= route.local < n_local
                assert sources[route.rank * n_local + route.local] == g, (rank, k, route)


@pytest.mark.parametrize("world,n_local", LAYOUTS)
def test_every_receive_buffer_has_one_writer(world, n_local):
    writes = [w for rank in range(world)
              for pair in cuda_kernels.ring_peer_routes(rank, world, n_local) for w in pair]
    assert len(writes) == len(set(writes)) == 2 * world * n_local
    # a process writes into other processes twice: its last shard's block
    # into the right neighbour, its first shard's into the left one
    for rank in range(world):
        remote = [w for pair in cuda_kernels.ring_peer_routes(rank, world, n_local)
                  for w in pair if w.rank != rank]
        assert len(remote) == 2


@pytest.mark.parametrize("world", [2, 3, 4])
def test_signals_reach_the_words_each_neighbour_waits_on(world):
    words = cuda_kernels.PEER_FLAGS.index
    got = {}
    for rank in range(world):
        for p, w in cuda_kernels.ring_peer_signals(rank, world):
            assert (p, w) not in got, "two processes signal one word"
            got[(p, w)] = rank
    for rank in range(world):
        left, right = (rank - 1) % world, (rank + 1) % world
        # each process waits on entered and delivered from both neighbours,
        # which are the processes that write into its buffers
        assert got[(rank, words("entered_from_left"))] == left
        assert got[(rank, words("entered_from_right"))] == right
        assert got[(rank, words("delivered_from_left"))] == left
        assert got[(rank, words("delivered_from_right"))] == right
        writers = {r for r in range(world) if r != rank
                   for pair in cuda_kernels.ring_peer_routes(r, world, 2) for w in pair
                   if w.rank == rank}
        assert writers == {left, right}
        # the schedule stores the signals and waits on the words they reach
        for epoch in (1, 2, 7):
            call = cuda_kernels.ring_peer_schedule(rank, world, 2, epoch)
            assert [(p, w) for p, w, _ in call.entered + call.delivered] == list(
                cuda_kernels.ring_peer_signals(rank, world))
            assert {v for _, _, v in call.entered + call.delivered} == {epoch}
            assert call.wait_entered == ((words("entered_from_left"), epoch - 1),
                                         (words("entered_from_right"), epoch - 1))
            assert call.wait_delivered == ((words("delivered_from_left"), epoch),
                                           (words("delivered_from_right"), epoch))


def test_allocation_layout_and_flags_match_the_kernel():
    from fastslam_tpu_torch.core import _build

    text = (_build.CSRC / "ring_halo.cu").read_text()
    for i, name in enumerate(cuda_kernels.PEER_FLAGS):
        assert f"PEER_{name.upper()} = {i}," in text, name
    assert text.count("  PEER_") == len(cuda_kernels.PEER_FLAGS)   # no word left out
    assert 8 * len(cuda_kernels.PEER_FLAGS) <= cuda_kernels.PEER_FLAG_BYTES
    assert cuda_kernels.PEER_SETS == 2
    nbytes = 389 * 25_000 * 4
    offsets = [cuda_kernels.ring_peer_offset(k, side, nbytes, parity)
               for k in range(3) for parity in range(2) for side in ("left", "right")]
    assert offsets[0] == cuda_kernels.PEER_FLAG_BYTES
    assert all(o % cuda_kernels.PEER_ALIGN == 0 for o in offsets)
    assert all(b - a >= nbytes for a, b in zip(offsets, offsets[1:]))   # 12 disjoint buffers
    assert cuda_kernels.ring_peer_offset(3, "left", nbytes) >= offsets[-1] + nbytes
    # a call writes and reads the buffer set of its parity
    for epoch in range(1, 6):
        call = cuda_kernels.ring_peer_schedule(1, 3, 3, epoch)
        assert call.parity == epoch % 2
        assert {r.parity for pair in call.writes + call.reads for r in pair} == {epoch % 2}


class FakeEvent:
    def __init__(self, log, name):
        self.log, self.name, self.done = log, name, True

    def record(self, stream):
        self.log.append(("event", self.name))

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return 0.0


def fake_ring(monkeypatch, log, bases, rank, n_local, nbytes):
    """A ``PeerRing`` of process ``rank`` of ``len(bases)`` (allocations at
    ``bases``) made without a card: its events, driver calls (waits and
    writes, as words and values) and launches are recorded in ``log``."""
    from fastslam_tpu_torch.core import _build

    ring = cuda_kernels.PeerRing.__new__(cuda_kernels.PeerRing)
    ring.rank, ring.world, ring.device = rank, len(bases), torch.device("meta")
    ring.base, ring.nbytes, ring._bases = bases[rank], nbytes, bases
    ring.epoch, ring.failed, ring._pending = 0, None, None
    ring.stats = dict.fromkeys(cuda_kernels.PEER_STATS, 0)
    ring._halos = {(k, side, parity): (k, side, parity)
                   for k in range(n_local) for side in ("left", "right") for parity in (0, 1)}
    ring._start, ring._entered, ring._copied, ring._done = (
        FakeEvent(log, n) for n in ("start", "entered", "copied", "done"))
    ring._entered_words = torch.zeros(2, dtype=torch.int64)    # the neighbours' entered
    ring._seen = torch.full((2,), -1, dtype=torch.int64)
    stream = lambda name: type("Stream", (), {"cuda_stream": name})()
    ring._release = stream(7)
    monkeypatch.setattr(cuda_kernels.PeerRing, "_index", property(lambda self: ctypes.c_int(0)))
    array = lambda ptr, n, t: list(ctypes.cast(ptr.value, ctypes.POINTER(t))[:n])

    class FakeLibrary:
        def _record(self, kind, words, values, count, stream):
            log.append((kind, list(zip(array(words, count.value, ctypes.c_uint64),
                                       array(values, count.value, ctypes.c_longlong)))))
            return 0

        def ring_peers_wait(self, index, *args):
            return self._record("wait", *args)

        def ring_peers_write(self, index, *args):
            return self._record("write", *args)

        def ring_halo_exchange_peers_launch(self, index, src, to_left, to_right, signal,
                                            flags, s, n, epoch, stream):
            log.append(("launch", array(to_left, s.value, ctypes.c_uint64),
                        array(to_right, s.value, ctypes.c_uint64),
                        array(signal, 4, ctypes.c_uint64), flags.value, epoch.value))
            return 0

    monkeypatch.setattr(_build, "load", lambda: FakeLibrary())
    monkeypatch.setattr(ring_kernels, "require_cuda", lambda *t: torch.device("meta"))
    monkeypatch.setattr(ring_kernels, "peer_ring", lambda *a: ring)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream(0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return ring


def test_the_wrapper_enqueues_the_schedule(monkeypatch):
    """``ring_halo_exchange_peers`` over a ``PeerRing`` of process 1 of 3
    (its driver calls and launch recorded, no card): per call, the waits
    (a) on the words and values of ``ring_peer_schedule``, the launch with
    the pointers of its writes and signals and its epoch, the waits (c),
    and the halos of the call's buffer set."""
    world, rank, n_local, shape = 3, 1, 2, (64, 389)
    nbytes = 64 * 389 * 4
    bases = {0: 1 << 36, 1: 1 << 37, 2: 1 << 38}
    log = []
    ring = fake_ring(monkeypatch, log, bases, rank, n_local, nbytes)
    blocks = [torch.empty(shape, device="meta") for _ in range(n_local)]
    launches = cuda_kernels.LAUNCHES["ring_halo_exchange_peers"]
    word = lambda p, w: bases[p] + 8 * cuda_kernels.PEER_FLAGS.index(w)
    for epoch in range(1, 5):
        log.clear()
        ring._entered_words[:] = epoch - 1 - (epoch == 3)    # call 3 finds one unset
        lefts, rights = cuda_kernels.ring_halo_exchange_peers(blocks, "group")
        assert ring._seen.tolist() == [epoch - 1 - (epoch == 3)] * 2
        parity = epoch % 2
        # global shards 2 and 3: to the left buffers of 3 and 4, the right
        # buffers of 1 and 2
        at = lambda p, k, side: bases[p] + cuda_kernels.ring_peer_offset(k, side, nbytes, parity)
        assert log == [
            ("event", "start"),
            ("wait", [(word(1, "entered_from_left"), epoch - 1),
                      (word(1, "entered_from_right"), epoch - 1)]),
            ("event", "entered"),
            ("launch", [at(1, 1, "left"), at(2, 0, "left")],
             [at(0, 1, "right"), at(1, 0, "right")],
             [word(2, "entered_from_left"), word(0, "entered_from_right"),
              word(2, "delivered_from_left"), word(0, "delivered_from_right")],
             bases[1], epoch),
            ("event", "copied"),
            ("wait", [(word(1, "delivered_from_left"), epoch),
                      (word(1, "delivered_from_right"), epoch)]),
            ("event", "done")]
        assert lefts == [(0, "left", parity), (1, "left", parity)]
        assert rights == [(0, "right", parity), (1, "right", parity)]
        assert ring.epoch == epoch
    assert (ring.stats["calls"], ring.stats["entered_met"]) == (4, 3)
    assert cuda_kernels.LAUNCHES["ring_halo_exchange_peers"] == launches + 4
    cuda_kernels.LAUNCHES["ring_halo_exchange_peers"] = launches


def test_a_call_past_its_deadline_releases_the_stream_and_raises(monkeypatch):
    """A call whose wait (c) is not met within ``PEER_TIMEOUT_S``: the ring
    writes, from its second stream, the cancel word and every word the call
    waits on into its own region, the stream passes, and the call raises
    naming the process, the call and the wait; the ring is refused after."""
    bases = {0: 1 << 36, 1: 1 << 37}
    log = []
    peer_ring = cuda_kernels.peer_ring
    ring = fake_ring(monkeypatch, log, bases, 0, 1, 1024)
    monkeypatch.setattr(ring_kernels, "PEER_TIMEOUT_S", 0.05)
    blocks = [torch.empty((16, 16), device="meta")]
    launches = cuda_kernels.LAUNCHES["ring_halo_exchange_peers"]
    cuda_kernels.ring_halo_exchange_peers(blocks, "group")
    ring._done.done = False                  # the neighbour never delivers call 2
    streams = []                             # the stream of each wait or write
    ring._done.query = lambda: 7 in streams           # the release stream's write
    real = ring._enqueue
    ring._enqueue = lambda fn, words, stream: (real(fn, words, stream),
                                               streams.append(stream.cuda_stream))
    log.clear()
    with pytest.raises(RuntimeError, match="process 0 of 2: call 2 waited 0.05 s for its "
                                           "neighbours' delivered words"):
        cuda_kernels.ring_halo_exchange_peers(blocks, "group")
    word = lambda w: bases[0] + 8 * cuda_kernels.PEER_FLAGS.index(w)
    assert log[-1] == ("write", [(word("cancelled"), 2), (word("entered_from_left"), 1),
                                 (word("entered_from_right"), 1),
                                 (word("delivered_from_left"), 2),
                                 (word("delivered_from_right"), 2)])
    assert streams == [0, 0, 7] and "still blocked" not in ring.failed
    assert ring.stats["calls"] == 1          # the failed call is not counted
    cuda_kernels.LAUNCHES["ring_halo_exchange_peers"] = launches
    key = ("group", torch.device("meta"), 1, (16, 16))
    monkeypatch.setattr(ring_kernels, "_PEER_RINGS", {key: ring})
    with pytest.raises(RuntimeError, match="failed earlier"):
        peer_ring(*key)


MODEL_LAYOUTS = [(2, 1), (2, 2), (3, 1), (3, 2), (4, 1), (4, 2)]
MODEL_CALLS = 8


def simulate(world, n_local, calls, rng, speeds, lefts, rights):
    """Run ``calls`` calls of ``ring_peer_schedule`` in each of ``world``
    processes, one step at a time: a wait steps when its words have
    reached their values; the kernel's stores of entered and its writes
    step in any order, its stores of delivered after every write; a process
    reads its halos after (c), and has consumed them when its next kernel
    starts (stream order).  ``rng`` picks the next step among those that
    can, a process with weight ``speeds[p]``.  Fails on a write into a
    buffer set whose owner is still reading it, on a halo that is not the
    block ``lefts``/``rights`` (receiving shard -> sending shard) route
    there, and when no process can step before all are done.  Returns how
    many waits (a) were met as soon as they were reached, and their count."""
    words = cuda_kernels.PEER_FLAGS
    flags = [[0] * len(words) for _ in range(world)]
    buffers = {}                 # (process, shard, buffer, set) -> (sending shard, call)
    reading = set()              # (process, set) whose halos are not yet consumed

    def program(p):
        for epoch in range(1, calls + 1):
            call = cuda_kernels.ring_peer_schedule(p, world, n_local, epoch)
            yield [("wait_entered", call.wait_entered)]
            yield [("consumed", (p, 1 - call.parity))]
            body = [("store", s) for s in call.entered]
            body += [("write", (route, p * n_local + k, epoch))
                     for k, pair in enumerate(call.writes) for route in pair]
            yield body
            yield [("store", s) for s in call.delivered]
            yield [("wait", call)]       # (c), then the halos are read

    phases = [program(p) for p in range(world)]
    pending = [next(phases[p]) for p in range(world)]
    met = reached = 0
    ready = lambda waits, p: all(flags[p][w] >= v for w, v in waits)
    while any(pending):
        choices = [(p, i) for p in range(world) if pending[p]
                   for i, (kind, arg) in enumerate(pending[p])
                   if kind == "wait_entered" and ready(arg, p)
                   or kind == "wait" and ready(arg.wait_delivered, p)
                   or kind not in ("wait", "wait_entered")]
        assert choices, f"deadlock: {pending}"
        blocked_a = {p for p in range(world) if pending[p]
                     and pending[p][0][0] == "wait_entered"}
        p, i = rng.choices(choices, weights=[speeds[c[0]] for c in choices])[0]
        kind, arg = pending[p].pop(i)
        if kind == "wait_entered" and p in blocked_a:
            reached += 1
            met += ready(arg, p)
        if kind == "consumed":
            reading.discard(arg)
        elif kind == "store":
            q, w, v = arg
            assert v > flags[q][w], "a word went back"
            flags[q][w] = v
        elif kind == "write":
            route, source, epoch = arg
            assert (route.rank, route.parity) not in reading, (
                f"call {epoch} of process {p} wrote into set {route.parity} of process "
                f"{route.rank}, which is still reading it")
            buffers[route.rank, route.local, route.buffer, route.parity] = (source, epoch)
        elif kind == "wait":
            for k, (left, right) in enumerate(arg.reads):
                g = p * n_local + k
                assert buffers.get(left) == (lefts[g], arg.epoch), (p, k, arg.epoch)
                assert buffers.get(right) == (rights[g], arg.epoch), (p, k, arg.epoch)
            reading.add((p, arg.parity))
        if not pending[p]:
            pending[p] = next(phases[p], [])
    return met, reached


@pytest.mark.parametrize("world,n_local", MODEL_LAYOUTS)
def test_protocol_model_has_no_overrun_no_deadlock_and_routes_as_ppermute(monkeypatch, world,
                                                                            n_local):
    lefts = ppermute_sources(monkeypatch, world, n_local, 1)
    rights = ppermute_sources(monkeypatch, world, n_local, -1)
    counts = []

    @settings(max_examples=60, deadline=None, database=None)
    @given(seed=st.integers(0, 2 ** 32 - 1),
           speeds=st.lists(st.integers(1, 32), min_size=world, max_size=world))
    def run(seed, speeds):
        counts.append(simulate(world, n_local, MODEL_CALLS, random.Random(seed), speeds,
                               lefts, rights))

    run()
    # (c) of call e - 1 implies (a) of call e: a neighbour that delivered
    # e - 1 had entered e - 1, so every wait (a) is met when reached
    assert counts and all(met == reached == world * MODEL_CALLS for met, reached in counts)


def test_protocol_model_catches_one_buffer_set(monkeypatch):
    """The model is not vacuous: with one receive buffer set, a neighbour
    one call ahead overwrites halos before or while they are read."""
    lefts = ppermute_sources(monkeypatch, 2, 1, 1)
    rights = ppermute_sources(monkeypatch, 2, 1, -1)
    monkeypatch.setattr(ring_kernels, "PEER_SETS", 1)
    failures = 0
    for seed in range(40):
        try:
            simulate(2, 1, MODEL_CALLS, random.Random(seed), [1, 8], lefts, rights)
        except AssertionError as e:
            assert "deadlock" not in str(e)
            failures += 1
    assert failures > 0


def test_cpu_blocks_take_the_plain_exchange_and_no_ring(monkeypatch):
    called = []
    monkeypatch.setattr(ring_kernels, "peer_ring", lambda *a: called.append(a))
    monkeypatch.setattr(collectives, "dist", FakeDist(1))
    blocks = [torch.randn(5, 7) for _ in range(3)]
    launches = dict(cuda_kernels.LAUNCHES)
    lefts, rights = cuda_kernels.ring_halo_exchange_peers(blocks, "group")
    assert not called and cuda_kernels.LAUNCHES == launches
    for k in range(3):
        assert torch.equal(lefts[k], blocks[k - 1])
        assert torch.equal(rights[k], blocks[(k + 1) % 3])


@pytest.mark.parametrize("processes,shards", [(2, 2), (3, 1)])
def test_probe_runs_across_processes_on_the_cpu(processes, shards):
    out = subprocess.run(
        [sys.executable, "-m", "fastslam_tpu_torch.probes.check_ring_resample", "--device",
         "cpu", "--processes", str(processes), "--shards", str(shards), "--particles", "96",
         "--landmarks", "4", "--exchanges", "3", "--reps", "1", "--timeout", "120"],
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["ok"] and result["device"] == "cpu"
    assert result["ring_shards"] == processes * shards
    for profile in ("healthy", "collapsed"):
        assert set(result["resample"][profile]["max_abs_err"].values()) == {0.0}
        assert result["resample"][profile]["peer_launches"] == [0] * processes
    assert result["exchange"] == {"exchanges": 3, "max_abs_err": 0.0, "equal": True,
                                  "launches": [0] * processes}
    assert result["back_to_back"] == result["exchange"]
    assert result["waits"] == [dict.fromkeys(cuda_kernels.PEER_STATS, 0)] * processes
    assert len(result["times"]) == processes
    assert all(len(t[k]) == 2 for t in result["times"] for k in ("kernel", "plain", "ring",
                                                                   "halo"))
