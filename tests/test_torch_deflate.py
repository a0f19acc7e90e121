"""The checkpoint's DEFLATE encoder and its zip container, on the CPU.

* ``cuda_kernels.deflate_fixed`` on CPU tensors (its plain version, which
  mirrors ``csrc/deflate.cu``): the stream inflates with zlib to the
  member's exact bytes on crafted members (all zeros, rows equal to the
  previous, runs past 258 bytes, bytes of 9-bit literals, one particle,
  rows of 4, 12, 512 and 1024 bytes, the planes layout, no bytes at all);
  its CRC fold equals ``zlib.crc32``;
* the zip container of either layout, with members large enough for the
  encoder, as ``save_checkpoint`` writes it from the CPU (zlib) and as it
  writes it from the card (the encoder's streams, here the plain
  version's): ``zipfile``'s ``testzip``, the benchmark's plain reader
  (``benchmark.reference.hooks.read_npz``), ``np.load`` and the JAX
  package's loader read every array bit for bit, under the names, dtypes
  and shapes ``np.savez_compressed`` gives; a member past 4 GiB is refused;
* the production hooks' counters of what the card encoded (nothing on the
  CPU).
"""

import io
import zipfile
import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference.hooks import read_npz
from fastslam_tpu.io import checkpoint as jax_checkpoint
from fastslam_tpu_torch.app.runner import ProductionHooks, SLAMRunner
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.core.cuda_kernels.deflate import _multmodp, _x2nmodp
from fastslam_tpu_torch.core.state import FilterState, PlanesState, init_state, to_planes
from fastslam_tpu_torch.eval.metrics import evaluate_tick
from fastslam_tpu_torch.io import checkpoint
from fastslam_tpu_torch.utils import profiling

torch.set_num_threads(1)

P, L = 48, 64


def filled(shape, rng, slots=9):
    """Zeros but for the first ``slots`` of each particle's map, as the
    online maps are; each odd particle a copy of the even one before it."""
    a = np.zeros(shape, np.float32)
    a[:, :slots] = rng.normal(size=(shape[0], slots) + shape[2:])
    a[1::2] = a[0:shape[0] - 1:2]
    return a


def crafted(case):
    """``(tensor, row_bytes)`` of one crafted member."""
    rng = np.random.default_rng(len(case))
    if case == "zeros":
        return np.zeros((P, L, 4), np.float32), 16 * L
    if case == "row_repeats":
        return filled((P, L, 2), rng), 8 * L
    if case == "long_runs":       # one byte value over 12 KB: runs cut into 258-byte pieces
        return np.full(3000, 0x41414141, np.uint32), 0
    if case == "high_bytes":      # every literal a 9-bit code
        return rng.integers(144, 256, size=(P, 512), dtype=np.uint8), 512
    if case == "one_particle":
        return rng.normal(size=(1, L, 4)).astype(np.float32), 16 * L
    if case.startswith("row_"):
        row = int(case[4:])
        a = np.zeros((P * L * 16 // row, row // 4), np.float32)
        a[:, :max(1, row // 16)] = rng.normal(size=(len(a), max(1, row // 16)))
        a[2::3] = a[1:len(a) - 1:3][:len(a[2::3])]
        return a, row
    if case == "planes":          # [L, P] rows of P floats: no row distance
        a = np.zeros((16, 3000), np.float32)
        a[:5, ::7] = rng.normal(size=(5, 429))
        return a, 0
    assert case == "empty"
    return np.zeros((0, 4), np.float32), 16


CASES = ["zeros", "row_repeats", "long_runs", "high_bytes", "one_particle", "row_4", "row_12",
         "row_512", "row_1024", "planes", "empty"]


@pytest.mark.parametrize("case", CASES)
def test_plain_stream_inflates_to_the_member(case):
    array, row = crafted(case)
    data = array.tobytes()
    seed = zlib.crc32(case.encode())
    stream, info = cuda_kernels.deflate_fixed(torch.from_numpy(array), row, seed)
    bits, crc, matched = info.tolist()
    n = (bits + 7) // 8
    raw = stream.numpy().tobytes()
    assert len(raw) == 4 * cuda_kernels.deflate_stream_words(len(data))
    assert raw[0] & 7 == 3                              # BFINAL 1, BTYPE 01
    assert not any(raw[n:])                             # zeros past the stream
    assert bits <= 3 + 9 * len(data) + 7
    assert zlib.decompress(raw[:n], wbits=-15) == data
    assert crc == zlib.crc32(data, seed)
    seg, distance = cuda_kernels.deflate_layout(row)
    assert seg % 4 == 0 and (distance == 0 or seg >= cuda_kernels.DEFLATE_MIN_SEGMENT)
    if distance == 0:
        assert matched == 0
    elif case in ("zeros", "row_repeats") or case.startswith("row_"):
        assert 0 < matched <= len(data)


@pytest.mark.parametrize("nbytes,row,seed", [(4, 4, 0), (1020, 12, 1), (4096, 1024, 0xFFFFFFFF),
                                             (4100, 1024, 7), (65540, 0, 0x80000000),
                                             (123452, 512, 12345)])
def test_crc_fold_equals_zlib(nbytes, row, seed):
    """The member's CRC, folded from its segments' CRCs shifted over the
    bytes after each, equals zlib's over the whole; and the shift combines
    two CRCs as ``crc32_combine`` does."""
    data = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8)
    _, info = cuda_kernels.deflate_fixed(torch.from_numpy(data), row, seed)
    assert int(info[1]) == zlib.crc32(data.tobytes(), seed)
    a, b = data[: nbytes // 3].tobytes(), data[nbytes // 3:].tobytes()
    shift = _x2nmodp(torch.tensor([len(b)]), 3)
    combined = int(_multmodp(shift, torch.tensor([zlib.crc32(a)]))) ^ zlib.crc32(b)
    assert combined == zlib.crc32(a + b)


def states():
    cfg = FastSLAMConfig(num_particles=600, max_landmarks=L, parity_mode=False)
    rng = np.random.default_rng(3)
    st = init_state(cfg, "cpu")
    st = st.replace(lm_mean=torch.from_numpy(filled((600, L, 2), rng)),
                    lm_cov=torch.from_numpy(filled((600, L, 4), rng)),
                    lm_count=torch.full((600,), 9, dtype=torch.int32),
                    poses=torch.from_numpy(rng.normal(size=(600, 3)).astype(np.float32)))
    return {"blocks": st, "planes": to_planes(st, cfg)}


POSE = np.array([0.5, -1.0, 0.25])


def reads_back_bit_for_bit(path, state, gen):
    """Every array of ``state`` and the loop state read back from the
    checkpoint at ``path`` through each reader, bit for bit."""
    arrays = {k: v.numpy() for k, v in state.__dict__.items() if v is not None}
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
        assert all(i.compress_type == zipfile.ZIP_DEFLATED for i in z.infolist())
    got = read_npz(path)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert int(got["format_version"]) == 1 and int(got["iteration"]) == 9
    assert ("layout" in got) == isinstance(state, PlanesState)
    np.testing.assert_array_equal(got["robot_pose"], POSE)
    np.testing.assert_array_equal(got["torch_generator_state"], gen.get_state().numpy())
    # np.savez_compressed of the same arrays: the same names, dtypes, shapes
    buf = io.BytesIO()
    np.savez_compressed(buf, **got)
    with np.load(path) as mine, np.load(io.BytesIO(buf.getvalue())) as theirs:
        assert mine.files == theirs.files
        for k in mine.files:
            assert mine[k].dtype == theirs[k].dtype and mine[k].shape == theirs[k].shape
            assert np.array_equal(mine[k], theirs[k]), k
    back, meta = checkpoint.load_checkpoint(path, "cpu")
    assert type(back) is type(state) and meta["iteration"] == 9
    for k, v in state.__dict__.items():
        assert (getattr(back, k) is None) if v is None else torch.equal(getattr(back, k), v), k
    jstate, jmeta = jax_checkpoint.load_checkpoint(path)
    assert jmeta["iteration"] == 9
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(getattr(jstate, k)), v, err_msg=k)


@pytest.mark.parametrize("layout", ["blocks", "planes"])
def test_an_encoded_checkpoint_reads_back_bit_for_bit(tmp_path, layout):
    """``save_checkpoint`` of a state on the CPU: zlib deflates every
    member into the container, and the card encodes nothing."""
    state = states()[layout]
    gen = torch.Generator().manual_seed(4)
    path = str(tmp_path / "ck.npz")
    stats = checkpoint.save_checkpoint(path, state, iteration=9, robot_pose=POSE, generator=gen)
    assert stats == (0, 0) and stats.match_pct == 0.0
    reads_back_bit_for_bit(path, state, gen)


@pytest.mark.parametrize("layout", ["blocks", "planes"])
def test_the_encoders_container_reads_back_bit_for_bit(tmp_path, layout):
    """The container ``save_checkpoint`` writes from the card, its large
    members the encoder's streams (here the plain version's, which equal the
    kernel's byte for byte), each behind its ``.npy`` header in a stored
    block."""
    state = states()[layout]
    gen = torch.Generator().manual_seed(4)
    path = str(tmp_path / "ck.npz")
    large = checkpoint.encoder_members(state)
    encoded, stats = checkpoint._encoded(large)
    assert large and sorted(encoded) == sorted(name for name, _, _ in large)
    assert stats.device_bytes == sum(t.nbytes for _, t, _ in large)
    assert (stats.row_match_bytes > 0) == (layout == "blocks")
    members = checkpoint._members(state, 9, POSE, None, gen)
    checkpoint._write_file(path, checkpoint._entries(members, encoded))
    reads_back_bit_for_bit(path, state, gen)


def test_a_member_past_4_gib_is_refused(tmp_path):
    meta = lambda *shape: torch.empty(shape, device="meta")
    big = (2 ** 20 + 1, 256, 4)                         # 4 GiB and 4 KiB of float32
    state = FilterState(poses=meta(big[0], 3), log_weights=meta(big[0]),
                        lm_mean=meta(big[0], 256, 2), lm_cov=meta(*big),
                        lm_count=torch.empty(big[0], dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match=f"lm_cov holds {4 * np.prod(big)} bytes"):
        checkpoint.save_checkpoint(str(tmp_path / "ck.npz"), state)
    assert not list(tmp_path.iterdir())


def test_hooks_count_what_the_encoder_took(tmp_path):
    cfg = FastSLAMConfig(num_particles=300, max_landmarks=L, parity_mode=False)
    hooks = ProductionHooks(cfg, checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=2)
    runner = SLAMRunner(cfg, rng=0, device="cpu")
    est = gt = np.zeros(3)
    ev = evaluate_tick(gt, est)
    profiling.HOOK_TRACE.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for t in range(3):
            hooks.after_tick(runner, t, est, gt, ev)
    rows = profiling.HOOK_TRACE.rows()
    profiling.HOOK_TRACE.clear()
    counters = rows[2]["counters"]
    # a state on the CPU goes through zlib: the card encodes nothing
    assert counters["checkpoint_device_bytes"] == hooks.checkpoint_device_bytes == 0
    assert counters["checkpoint_match_pct"] == hooks.checkpoint_match_pct == 0.0
    assert counters["checkpoint_bytes"] == hooks.checkpoint_bytes > 0
    assert "checkpoint_match_pct" not in rows[1]["counters"]
    assert checkpoint.load_checkpoint(str(tmp_path / "ck.npz"), "cpu")[1]["iteration"] == 2
