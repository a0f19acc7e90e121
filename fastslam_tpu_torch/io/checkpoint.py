"""Checkpoint and resume of the full filter state.

Counterpart of ``fastslam_tpu/io/checkpoint.py``, in its ``.npz`` format
(``format_version`` 1, the same field names), so a checkpoint the JAX
package wrote loads here with the same arrays.  Either layout is saved as it
is: a :class:`~fastslam_tpu_torch.core.state.PlanesState` (``layout`` =
``"planes"``, the ``[L, P]`` planes under their names, no ``lm_cc`` in
production) or a :class:`~fastslam_tpu_torch.core.state.FilterState`
(``lm_mean``, ``lm_cov``), with the loop's iteration counter and
dead-reckoned pose.  The write is atomic: a temporary file in the target's
directory, then ``os.replace``; no fsync.

The file reads as ``np.savez_compressed``'s does (the same member names,
numpy's own ``.npy`` headers, deflated members), but its zip container is
written here: on the card each state tensor of at least
:data:`ENCODER_MIN_BYTES` is deflated where it lies by
``cuda_kernels.deflate_fixed`` (its ``.npy`` header as a stored block, then
the encoder's block of fixed Huffman codes and its CRC-32), so the state
leaves the card as its compressed stream; every other member, and every
member of a state on the CPU, goes through zlib on the host.

The port keeps its randomness in a :class:`torch.Generator`, not in the
state: :func:`save_checkpoint` stores the generator's state
(``torch_generator_state``) and :func:`load_checkpoint` returns a generator
that continues its stream.  A JAX checkpoint carries a threefry key
(``rng_key_data``) instead; the port seeds a fresh generator from it, so the
resumed draws differ from the ones JAX would take.  So that the JAX
package's loader, which reads that key unconditionally, takes a port
checkpoint too, :func:`save_checkpoint` also writes a key: the generator's
initial seed split into two 32-bit words, as ``jax.random.PRNGKey`` splits a
64-bit seed (zeros without a generator).
"""

from __future__ import annotations

import io
import os
import struct
import tempfile
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.core.state import FilterState, PlanesState

_FORMAT_VERSION = 1

_PLANE_FIELDS = ("lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cc", "lm_cd")

# a state member on the card of this many bytes goes through the encoder
# (cuda_kernels.deflate_fixed); a smaller one through zlib on the host
ENCODER_MIN_BYTES = 64 * 1024
# the zip format's sizes and offsets (no zip64)
_ZIP32_MAX = 0xFFFFFFFF
_DOS_DATE = 1 << 5 | 1            # 1980-01-01, 00:00
_pinned: Optional[torch.Tensor] = None   # the streams' host buffer, kept between calls


class CheckpointStats(NamedTuple):
    """What :func:`save_checkpoint` encoded on the card: the raw bytes of
    the members the encoder took (0 for a state on the CPU), and those that
    matches at the row distance cover."""

    device_bytes: int
    row_match_bytes: int

    @property
    def match_pct(self) -> float:
        """The share of the encoded bytes that row matches cover, in %."""
        return 100.0 * self.row_match_bytes / self.device_bytes if self.device_bytes else 0.0


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _threefry_key(generator: Optional[torch.Generator]) -> np.ndarray:
    """``uint32[2]``: the generator's initial seed as (high word, low word),
    the key ``jax.random.PRNGKey`` makes of a 64-bit seed; zeros for None."""
    seed = 0 if generator is None else generator.initial_seed() % 2 ** 64
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _members(state, iteration, robot_pose, extra, generator) -> list:
    """``(name, value, row_bytes)`` in ``np.savez``'s order: the state's
    tensors as they are, with the bytes of one particle's slice (0 for the
    planes layout's ``[L, P]`` planes), and the rest as numpy arrays."""
    row = lambda t: t.nbytes // max(len(t), 1)
    out = [("format_version", np.int32(_FORMAT_VERSION), 0)]
    out += [(f, getattr(state, f), row(getattr(state, f)))
            for f in ("poses", "log_weights", "lm_count")]
    out += [("rng_key_data", _threefry_key(generator), 0),
            ("iteration", np.int64(iteration), 0),
            ("robot_pose", np.asarray(robot_pose if robot_pose is not None else np.zeros(3)), 0)]
    if generator is not None:
        out.append(("torch_generator_state", _host(generator.get_state()), 0))
    if isinstance(state, PlanesState):
        out.append(("layout", np.asarray("planes"), 0))
        # production states carry no cc plane (cc == cb)
        out += [(f, getattr(state, f), 0) for f in _PLANE_FIELDS if getattr(state, f) is not None]
    else:
        out += [(f, getattr(state, f), row(getattr(state, f))) for f in ("lm_mean", "lm_cov")]
    out += [("extra_" + k, np.asarray(v), 0) for k, v in (extra or {}).items()]
    return out


def encoder_members(state) -> list:
    """``(name, tensor, row_bytes)`` of the state's tensors of at least
    :data:`ENCODER_MIN_BYTES`, in the file's order: what
    :func:`save_checkpoint` deflates with ``cuda_kernels.deflate_fixed``
    when the state is on the card."""
    return [m for m in _members(state, 0, None, None, None)
            if isinstance(m[1], torch.Tensor) and m[1].nbytes >= ENCODER_MIN_BYTES]


def _npy_header(dtype: np.dtype, shape) -> bytes:
    """numpy's version 1.0 ``.npy`` header, as ``np.savez`` writes it."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, {"descr": np.lib.format.dtype_to_descr(dtype),
                                               "fortran_order": False, "shape": tuple(shape)})
    return buf.getvalue()


def _deflated(array: np.ndarray):
    """``(crc, size, [data])`` of a member deflated by zlib on the host."""
    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.asanyarray(array), allow_pickle=False)
    raw = buf.getvalue()
    z = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, -15)
    return zlib.crc32(raw), len(raw), [z.compress(raw) + z.flush()]


def _pinned_buffer(nbytes: int) -> torch.Tensor:
    """A pinned host buffer of at least ``nbytes``, kept between calls."""
    global _pinned
    if _pinned is None or _pinned.numel() < nbytes:
        _pinned = torch.empty(nbytes + nbytes // 4, dtype=torch.uint8, pin_memory=True)
    return _pinned


def _encoded(members: list):
    """``{name: (crc, size, [data])}`` of the members the encoder takes, and
    their :class:`CheckpointStats`: each member's ``.npy`` header as a stored
    block (BTYPE 00, BFINAL 0), then the encoder's block.  The encoder's
    lengths and CRCs come back in one read; on CUDA its streams (not the
    state) are copied into a pinned buffer, on the CPU (the plain version)
    they are used where they lie."""
    headers = {name: _npy_header(torch.empty(0, dtype=t.dtype).numpy().dtype, t.shape)
               for name, t, _ in members}
    runs = {name: cuda_kernels.deflate_fixed(t.detach().contiguous(), row,
                                             zlib.crc32(headers[name]))
            for name, t, row in members}
    if not runs:
        return {}, CheckpointStats(0, 0)
    infos = torch.stack([info for _, info in runs.values()]).tolist()
    lengths = [(bits + 7) // 8 for bits, _, _ in infos]
    device = members[0][1].device
    if device.type == "cuda":
        host = _pinned_buffer(sum(lengths))
        streams, at = [], 0
        for (stream, _), n in zip(runs.values(), lengths):
            host[at:at + n].copy_(stream[:n], non_blocking=True)
            streams.append(host[at:at + n].numpy())
            at += n
        torch.cuda.current_stream(device).synchronize()
    else:
        streams = [stream[:n].numpy() for (stream, _), n in zip(runs.values(), lengths)]
    out = {}
    for (name, t, _), (_, crc, _), stream in zip(members, infos, streams):
        h = headers[name]
        stored = struct.pack("<BHH", 0, len(h), len(h) ^ 0xFFFF) + h
        out[name] = (crc, len(h) + t.nbytes, [stored, stream])
    stats = CheckpointStats(sum(t.nbytes for _, t, _ in members),
                            sum(rows for _, _, rows in infos))
    return out, stats


def _write_zip(f, members: list) -> None:
    """The zip container of ``(name, crc, size, [data])`` deflated members:
    local headers (method 8, the CRC and sizes), the data, the central
    directory and its end record; members named ``<name>.npy``."""
    central, offset = [], 0
    for name, crc, size, chunks in members:
        fname = (name + ".npy").encode()
        csize = sum(len(c) for c in chunks)
        if max(offset, csize, size) > _ZIP32_MAX:
            raise ValueError(f"checkpoint member {name}: the file passes the zip format's "
                             f"4 GiB at offset {offset}")
        head = struct.pack("<4s5H3L2H", b"PK\x03\x04", 20, 0, 8, 0, _DOS_DATE, crc, csize, size,
                           len(fname), 0) + fname
        f.write(head)
        for c in chunks:
            f.write(c)
        central.append(struct.pack("<4s6H3L5H2L", b"PK\x01\x02", 20, 20, 0, 8, 0, _DOS_DATE, crc,
                                   csize, size, len(fname), 0, 0, 0, 0, 0, offset) + fname)
        offset += len(head) + csize
    directory = b"".join(central)
    if offset > _ZIP32_MAX:
        raise ValueError(f"the checkpoint passes the zip format's 4 GiB at offset {offset}")
    f.write(directory)
    f.write(struct.pack("<4s4H2LH", b"PK\x05\x06", 0, 0, len(members), len(members),
                        len(directory), offset, 0))


def save_checkpoint(path: str, state, *, iteration: int = 0, robot_pose=None,
                    extra: Optional[dict] = None,
                    generator: Optional[torch.Generator] = None) -> CheckpointStats:
    """Atomically write the filter state (either layout), the loop state, a
    threefry key for the JAX package's loader and, when given, the
    generator's state, as ``np.savez_compressed`` would.

    On CUDA each state tensor of at least :data:`ENCODER_MIN_BYTES`
    (:func:`encoder_members`) is deflated on the card by
    :func:`~fastslam_tpu_torch.core.cuda_kernels.deflate_fixed`, so only its
    stream comes to the host.  Every other member, and every member of a
    state on the CPU, is deflated by zlib on the host.  The zip container
    around them is written here.  A member past 4 GiB raises ``ValueError``
    (the format has no zip64 here).  Returns what the card encoded
    (:class:`CheckpointStats`)."""
    members = _members(state, iteration, robot_pose, extra, generator)
    for name, v, _ in members:
        if v.nbytes > _ZIP32_MAX:
            raise ValueError(f"checkpoint member {name} holds {v.nbytes} bytes, past the zip "
                             "format's 4 GiB")
    encoded, stats = _encoded(encoder_members(state) if state.poses.is_cuda else [])
    _write_file(path, _entries(members, encoded))
    return stats


def _entries(members: list, encoded: dict) -> list:
    """``(name, crc, size, [data])`` of every member: the encoder's where it
    took the member (``encoded``), else zlib's on the host."""
    return [(name, *(encoded[name] if name in encoded else
                     _deflated(_host(v) if isinstance(v, torch.Tensor) else v)))
            for name, v, _ in members]


def _write_file(path: str, entries: list) -> None:
    """The zip container of ``entries`` (:func:`_write_zip`), written to a
    temporary file in ``path``'s directory and moved onto ``path`` by
    ``os.replace``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            _write_zip(f, entries)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _generator(z, device: torch.device) -> Optional[torch.Generator]:
    """The saved generator; one seeded from a JAX checkpoint's threefry key
    (a new stream); None when the checkpoint holds neither."""
    gen = torch.Generator(device=device)
    if "torch_generator_state" in z.files:
        gen.set_state(torch.from_numpy(z["torch_generator_state"]))
    elif "rng_key_data" in z.files:
        key = np.ascontiguousarray(z["rng_key_data"]).tobytes()
        gen.manual_seed(int.from_bytes(key[:8].ljust(8, b"\0"), "little"))
    else:
        return None
    return gen


def load_checkpoint(path: str, device: torch.device | str = "cuda"):
    """Returns ``(state, meta)``: the state in the layout it was saved in, on
    ``device``, and ``meta`` with ``iteration``, ``robot_pose``, ``extra``
    and ``generator`` (a :class:`torch.Generator` on ``device``: the saved
    one, else one seeded from the threefry key; None when the checkpoint
    holds neither)."""
    device = torch.device(device)
    with np.load(path) as z:
        version = int(z["format_version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        t = lambda name: torch.from_numpy(z[name]).to(device)
        if "layout" in z.files and str(z["layout"]) == "planes":
            state = PlanesState(
                poses=t("poses"), log_weights=t("log_weights"), lm_count=t("lm_count"),
                **{f: (t(f) if f in z.files else None) for f in _PLANE_FIELDS})
        else:
            state = FilterState(poses=t("poses"), log_weights=t("log_weights"),
                                lm_mean=t("lm_mean"), lm_cov=t("lm_cov"),
                                lm_count=t("lm_count"))
        meta = {
            "iteration": int(z["iteration"]),
            "robot_pose": np.asarray(z["robot_pose"]),
            "extra": {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")},
            "generator": _generator(z, device),
        }
    return state, meta
