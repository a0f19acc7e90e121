"""The ``FSLG1`` binary laser-log codec (counterpart of
``fastslam_tpu/io/native_log.py``): a ``ctypes`` binding of the native C++
library, and a numpy codec that reads and writes the same bytes.

``FSLG1`` (layout in ``native/logcodec.cpp``) is a 64-byte header and
fixed-size tick records, for O(1) random access into long logs.  The
library is built from ``native/logcodec.cpp`` by ``native/Makefile`` into
``build/native/`` at its first use (``make`` and a C++ compiler on the
path); without them the numpy codec reads and writes the identical bytes.
The numpy codec is the file format's second implementation, not a device
fallback: neither touches the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_HEADER_BYTES = 64
_MAGIC = b"FSLG1"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libfslogcodec.so")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load_library() -> Optional[ctypes.CDLL]:
    """Load (building it if needed) the native codec; None if unavailable."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if not os.path.exists(_LIB_PATH) and os.path.isdir(_NATIVE_DIR):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            # native/Makefile's rule, run in the build directory with the
            # source found in native/
            subprocess.run(
                ["make", "-C", _BUILD_DIR, "-s", "-f", os.path.join(_NATIVE_DIR, "Makefile"),
                 "--eval", f"vpath %.cpp {_NATIVE_DIR}", "libfslogcodec.so"],
                check=True, capture_output=True, timeout=120,
            )
        lib = ctypes.CDLL(_LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return None

    u32 = ctypes.c_uint32
    f32p, f64p, i32p = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_double,
                                                    ctypes.c_int32))
    lib.fslog_write.restype = ctypes.c_int
    lib.fslog_write.argtypes = [ctypes.c_char_p, u32, u32, ctypes.c_float, ctypes.c_float,
                                f64p, f32p, f32p, i32p, i32p, f64p, f32p]
    lib.fslog_read_header.restype = ctypes.c_int
    lib.fslog_read_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(u32),
                                      ctypes.POINTER(u32), f32p, f32p]
    lib.fslog_read.restype = ctypes.c_int
    lib.fslog_read.argtypes = [ctypes.c_char_p, u32, u32, f64p, f32p, f32p, i32p, i32p,
                               f64p, f32p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_library() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _record_dtype(num_beams: int) -> np.dtype:
    return np.dtype([("timestamp", "<f8"), ("cmd_v", "<f4"), ("cmd_w", "<f4"),
                     ("bumper", "<u4"), ("gt", "<f8", (3,)), ("scan", "<f4", (num_beams,))])


def _record_bytes(num_beams: int) -> int:
    return 8 + 4 + 4 + 4 + 24 + 4 * num_beams


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------

def write_log(path: str, log, *, force_numpy: bool = False) -> str:
    """Write a LaserLog as FSLG1; returns ``'native'`` or ``'numpy'``."""
    t = len(log)
    b = log.scans.shape[1]
    timestamps = np.ascontiguousarray(log.timestamps, np.float64)
    cmd_v = np.ascontiguousarray(log.cmd_v, np.float32)
    cmd_w = np.ascontiguousarray(log.cmd_w, np.float32)
    bst = np.ascontiguousarray(log.bumper_state, np.int32)
    bid = np.ascontiguousarray(log.bumper_id, np.int32)
    gt = np.ascontiguousarray(log.gt_poses, np.float64)
    scans = np.ascontiguousarray(log.scans, np.float32)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)

    lib = None if force_numpy else _load_library()
    if lib is not None:
        rc = lib.fslog_write(
            path.encode(), t, b, ctypes.c_float(log.min_range), ctypes.c_float(log.max_range),
            _ptr(timestamps, ctypes.c_double), _ptr(cmd_v, ctypes.c_float),
            _ptr(cmd_w, ctypes.c_float), _ptr(bst, ctypes.c_int32),
            _ptr(bid, ctypes.c_int32), _ptr(gt, ctypes.c_double),
            _ptr(scans, ctypes.c_float))
        if rc != 0:
            raise OSError(f"fslog_write failed: {rc}")
        return "native"

    header = bytearray(_HEADER_BYTES)
    header[:5] = _MAGIC
    header[8:12] = np.uint32(t).tobytes()
    header[12:16] = np.uint32(b).tobytes()
    header[16:20] = np.float32(log.min_range).tobytes()
    header[20:24] = np.float32(log.max_range).tobytes()
    header[24:28] = np.uint32(_record_bytes(b)).tobytes()
    rec = np.zeros(t, dtype=_record_dtype(b))
    rec["timestamp"] = timestamps
    rec["cmd_v"] = cmd_v
    rec["cmd_w"] = cmd_w
    rec["bumper"] = (bst.astype(np.uint32) & 0xFF) | ((bid.astype(np.uint32) & 0xFF) << 8)
    rec["gt"] = gt
    rec["scan"] = scans
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())
    return "numpy"


# ---------------------------------------------------------------------------
# read
# ---------------------------------------------------------------------------

def _read_header(path: str):
    """``(ticks, beams, min_range, max_range)`` of a valid FSLG1 header."""
    with open(path, "rb") as f:
        header = f.read(_HEADER_BYTES)
    if len(header) < _HEADER_BYTES or header[:5] != _MAGIC:
        raise OSError("not an FSLG1 file")
    t_total = int(np.frombuffer(header[8:12], "<u4")[0])
    b = int(np.frombuffer(header[12:16], "<u4")[0])
    mn = float(np.frombuffer(header[16:20], "<f4")[0])
    mx = float(np.frombuffer(header[20:24], "<f4")[0])
    rec_bytes = int(np.frombuffer(header[24:28], "<u4")[0])
    if b == 0 or b > 1_000_000 or rec_bytes != _record_bytes(b):
        raise OSError("corrupt FSLG1 header: record size mismatch")
    return t_total, b, mn, mx


def _check_slice(path: str, t_total: int, b: int, start: int, count: Optional[int]) -> int:
    n = t_total - start if count is None else count
    if n < 0 or start + n > t_total:
        raise OSError(f"slice [{start}, {start}+{n}) out of range for {t_total} ticks")
    # a corrupt header may claim far more ticks than the file holds
    if _HEADER_BYTES + t_total * _record_bytes(b) > os.path.getsize(path):
        raise OSError("truncated FSLG1 file (header claims more ticks)")
    return n


def read_log(path: str, *, start: int = 0, count: Optional[int] = None,
             force_numpy: bool = False, mmap: bool = False):
    """Read a LaserLog (optionally the ticks ``[start, start + count)``)
    from FSLG1.  ``mmap=True`` maps the record block read-only instead of
    copying it: the scans stay a zero-copy strided view."""
    from fastslam_tpu_torch.drivers.replay import LaserLog

    if start < 0 or (count is not None and count < 0):
        raise ValueError("start/count must be non-negative")
    if mmap:
        return _read_log_mmap(path, start, count)
    lib = None if force_numpy else _load_library()
    if lib is not None:
        u32 = ctypes.c_uint32
        nt, nb = u32(), u32()
        mn, mx = ctypes.c_float(), ctypes.c_float()
        rc = lib.fslog_read_header(path.encode(), ctypes.byref(nt), ctypes.byref(nb),
                                   ctypes.byref(mn), ctypes.byref(mx))
        if rc != 0:
            raise OSError(f"fslog_read_header failed: {rc}")
        t_total, b = nt.value, nb.value
        n = _check_slice(path, t_total, b, start, count)
        timestamps = np.empty(n, np.float64)
        cmd_v = np.empty(n, np.float32)
        cmd_w = np.empty(n, np.float32)
        bst = np.empty(n, np.int32)
        bid = np.empty(n, np.int32)
        gt = np.empty((n, 3), np.float64)
        scans = np.empty((n, b), np.float32)
        rc = lib.fslog_read(
            path.encode(), start, n, _ptr(timestamps, ctypes.c_double),
            _ptr(cmd_v, ctypes.c_float), _ptr(cmd_w, ctypes.c_float),
            _ptr(bst, ctypes.c_int32), _ptr(bid, ctypes.c_int32),
            _ptr(gt, ctypes.c_double), _ptr(scans, ctypes.c_float))
        if rc != 0:
            raise OSError(f"fslog_read failed: {rc}")
        return LaserLog(scans=scans, min_range=float(mn.value), max_range=float(mx.value),
                        timestamps=timestamps, cmd_v=cmd_v, cmd_w=cmd_w,
                        bumper_state=bst, bumper_id=bid, gt_poses=gt)

    t_total, b, mn, mx = _read_header(path)
    dt = _record_dtype(b)
    n = _check_slice(path, t_total, b, start, count)
    with open(path, "rb") as f:
        f.seek(_HEADER_BYTES + start * dt.itemsize)
        data = f.read(n * dt.itemsize)
    if len(data) != n * dt.itemsize:
        raise OSError("truncated FSLG1 file")
    rec = np.frombuffer(data, dtype=dt)
    return LaserLog(
        scans=np.ascontiguousarray(rec["scan"]), min_range=mn, max_range=mx,
        timestamps=np.ascontiguousarray(rec["timestamp"]),
        cmd_v=np.ascontiguousarray(rec["cmd_v"]), cmd_w=np.ascontiguousarray(rec["cmd_w"]),
        bumper_state=(rec["bumper"] & 0xFF).astype(np.int32),
        bumper_id=((rec["bumper"] >> 8) & 0xFF).astype(np.int32),
        gt_poses=np.ascontiguousarray(rec["gt"]),
    )


def _read_log_mmap(path: str, start: int, count: Optional[int]):
    """Memory-mapped read: the scans are a zero-copy strided view into the
    page cache; the small per-tick columns are copied."""
    from fastslam_tpu_torch.drivers.replay import LaserLog

    t_total, b, mn, mx = _read_header(path)
    n = _check_slice(path, t_total, b, start, count)
    rec = np.memmap(path, dtype=_record_dtype(b), mode="r", offset=_HEADER_BYTES,
                    shape=(t_total,))[start:start + n]
    bumper = np.asarray(rec["bumper"])
    return LaserLog(
        scans=rec["scan"], min_range=mn, max_range=mx,
        timestamps=np.asarray(rec["timestamp"]), cmd_v=np.asarray(rec["cmd_v"]),
        cmd_w=np.asarray(rec["cmd_w"]),
        bumper_state=(bumper & 0xFF).astype(np.int32),
        bumper_id=((bumper >> 8) & 0xFF).astype(np.int32),
        gt_poses=np.asarray(rec["gt"]),
    )
