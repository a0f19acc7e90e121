"""The FSLG1 codec: the port's ``io/native_log.py`` against the JAX
package's.  Both packages write the same bytes for the same log, through
the native library and through the numpy codec, and each reads the other's
files; corrupt, truncated and out-of-range reads are refused cleanly by both
codecs; slices and memory-mapped reads match; a ``.fslog`` log replays."""

import os

import numpy as np
import pytest

from fastslam_tpu.drivers.replay import record_log as jax_record_log
from fastslam_tpu.drivers.sim_world import SimWorld as JaxSimWorld
from fastslam_tpu.io import native_log as jax_native_log

from fastslam_tpu_torch.drivers.replay import LaserLog, ReplayDriver, record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.io import native_log
from fastslam_tpu_torch.io.native_log import native_available, read_log, write_log


@pytest.fixture(scope="module")
def log():
    return record_log(SimWorld(seed=13), num_ticks=40)


def assert_logs_equal(a, b):
    for name in ("scans", "timestamps", "cmd_v", "cmd_w", "bumper_state", "bumper_id",
                 "gt_poses"):
        np.testing.assert_allclose(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
                                   rtol=1e-6, err_msg=name)
    assert a.min_range == pytest.approx(b.min_range)
    assert a.max_range == pytest.approx(b.max_range)


def test_native_library_builds_under_build(log):
    assert native_available(), "the C++ codec failed to build (make and g++ are needed)"
    assert os.path.dirname(native_log._LIB_PATH).endswith(os.path.join("build", "native"))
    assert os.path.isfile(native_log._LIB_PATH)


@pytest.mark.parametrize("force_numpy", [True, False])
def test_both_packages_write_the_same_bytes(tmp_path, log, force_numpy):
    jlog = jax_record_log(JaxSimWorld(seed=13), num_ticks=40)
    got, want = str(tmp_path / "port.fslog"), str(tmp_path / "jax.fslog")
    assert write_log(got, log, force_numpy=force_numpy) == (
        "numpy" if force_numpy else "native")
    jax_native_log.write_log(want, jlog, force_numpy=True)
    assert open(got, "rb").read() == open(want, "rb").read()
    assert_logs_equal(read_log(want, force_numpy=force_numpy), log)
    assert_logs_equal(jax_native_log.read_log(got, force_numpy=True), log)


@pytest.mark.parametrize("force_numpy", [True, False])
def test_mutated_bytes_fail_as_jax_fails(tmp_path, log, force_numpy):
    """Random corruptions of a valid file parse, or raise OSError/ValueError,
    in the port exactly when they do in the JAX package."""
    p = str(tmp_path / "fuzz.fslog")
    write_log(p, log, force_numpy=True)
    blob = bytearray(open(p, "rb").read())
    rng = np.random.default_rng(99)
    q = str(tmp_path / "mut.fslog")
    for trial in range(60):
        mutated = bytearray(blob)
        for _ in range(int(rng.integers(1, 5))):
            pos = int(rng.integers(0, 64 if trial % 2 else len(blob)))
            mutated[pos] = int(rng.integers(0, 256))
        open(q, "wb").write(bytes(mutated))
        outcome = []
        for read in (read_log, jax_native_log.read_log):
            try:
                outcome.append(len(read(q, force_numpy=force_numpy)))
            except (OSError, ValueError):
                outcome.append("refused")
        assert outcome[0] == outcome[1], trial


@pytest.mark.parametrize("force_numpy", [True, False])
def test_truncations_and_bad_slices_are_refused(tmp_path, log, force_numpy):
    p = str(tmp_path / "src.fslog")
    write_log(p, log, force_numpy=True)
    blob = open(p, "rb").read()
    q = str(tmp_path / "trunc.fslog")
    for cut in [0, 1, 4, 5, 8, 24, 63, 64, 65, 100, len(blob) // 2, len(blob) - 1]:
        open(q, "wb").write(blob[:cut])
        with pytest.raises((OSError, ValueError)):
            read_log(q, force_numpy=force_numpy)
    t = len(log)
    for start, count in [(t + 1, None), (0, t + 1), (t, 1), (2**31, 2**31), (5, t)]:
        with pytest.raises((OSError, ValueError)):
            read_log(p, start=start, count=count, force_numpy=force_numpy)
    with pytest.raises(ValueError):
        read_log(p, start=-1, force_numpy=force_numpy)


def test_slices_and_mmap_match_the_copy_read(tmp_path, log):
    p = str(tmp_path / "mm.fslog")
    write_log(p, log, force_numpy=True)
    for kw in ({"force_numpy": True}, {}, {"mmap": True}):
        part = read_log(p, start=7, count=9, **kw)
        assert len(part) == 9
        np.testing.assert_allclose(np.asarray(part.scans), log.scans[7:16], rtol=1e-6)
        want = jax_native_log.read_log(p, start=7, count=9, **kw)
        assert_logs_equal(part, want)
    assert_logs_equal(read_log(p, mmap=True), log)
    scan = ReplayDriver(read_log(p, mmap=True)).get_laser()
    np.testing.assert_allclose(np.asarray(scan.values), log.scans[0], rtol=1e-6)
    open(str(tmp_path / "half.fslog"), "wb").write(open(p, "rb").read()[:1000])
    with pytest.raises((OSError, ValueError)):
        read_log(str(tmp_path / "half.fslog"), mmap=True)


def test_replay_saves_and_loads_fslog(tmp_path, log):
    p = str(tmp_path / "log.fslog")
    log.save(p)
    assert_logs_equal(LaserLog.load(p), log)
