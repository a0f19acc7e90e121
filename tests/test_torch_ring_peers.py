"""The routing of the cross-process ring exchange, checked without a GPU.

``core/cuda_kernels.py:ring_peer_routes`` gives, for each local shard of a
process, the process, local shard and receive buffer that each of its
block's two writes goes to; the kernel (``csrc/ring_halo.cu``) writes
through exactly those pointers.  It must route as the plain exchange does:
``parallel/collectives.py:ppermute`` by +1 (the left halos) and -1 (the
right halos) over the group.  ``ppermute`` runs here in each simulated rank
of a group with a stand-in for ``torch.distributed``, which records every
point-to-point send and delivers it to the matching receive.  Beside it:
the flag words each process signals, the layout of a process's allocation,
and the probe of the ring across processes, on the CPU.
"""

import json
import subprocess
import sys

import pytest
import torch

from fastslam_tpu_torch.core import cuda_kernels
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
        # each process waits on ready and delivered from both neighbours,
        # which are the processes that write into its buffers
        assert got[(rank, words("ready_from_left"))] == left
        assert got[(rank, words("ready_from_right"))] == right
        assert got[(rank, words("delivered_from_left"))] == left
        assert got[(rank, words("delivered_from_right"))] == right
        writers = {r for r in range(world) if r != rank
                   for pair in cuda_kernels.ring_peer_routes(r, world, 2) for w in pair
                   if w.rank == rank}
        assert writers == {left, right}


def test_allocation_layout_and_flags_match_the_kernel():
    from fastslam_tpu_torch.core import _build

    text = (_build.CSRC / "ring_halo.cu").read_text()
    for i, name in enumerate(cuda_kernels.PEER_FLAGS):
        assert f"PEER_{name.upper()} = {i}," in text, name
    assert 8 * len(cuda_kernels.PEER_FLAGS) <= cuda_kernels.PEER_FLAG_BYTES
    nbytes = 389 * 25_000 * 4
    offsets = [cuda_kernels.ring_peer_offset(k, side, nbytes)
               for k in range(3) for side in ("left", "right")]
    assert offsets[0] == cuda_kernels.PEER_FLAG_BYTES
    assert all(o % cuda_kernels.PEER_ALIGN == 0 for o in offsets)
    assert all(b - a >= nbytes for a, b in zip(offsets, offsets[1:]))
    assert cuda_kernels.ring_peer_offset(3, "left", nbytes) >= offsets[-1] + nbytes


def test_cpu_blocks_take_the_plain_exchange_and_no_ring(monkeypatch):
    called = []
    monkeypatch.setattr(cuda_kernels, "peer_ring", lambda *a: called.append(a))
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
    assert len(result["times"]) == processes
    assert all(len(t[k]) == 2 for t in result["times"] for k in ("kernel", "plain", "ring",
                                                                   "halo"))
