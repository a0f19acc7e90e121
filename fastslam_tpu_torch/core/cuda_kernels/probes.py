"""The ceiling probes of the card and their plain PyTorch versions
(``csrc/probes.cu``), which the probe entry points of
:mod:`fastslam_tpu_torch.probes` time: the device-memory copy over the
fused update's buffer set (:func:`hbm_copy`), the shared-memory stream
(:func:`mul_add`) and the FP32 FMA rate (:func:`fma_chain`).
"""

from __future__ import annotations

import ctypes
import struct

import torch

from fastslam_tpu_torch.core.cuda_kernels._launch import (
    SMEM_OPT_IN_BYTES, launch, ptr, require_cuda,
)

# the copy probe's buffers (six [L, P] planes and one [1, P] row) and the
# floats one of its blocks moves per buffer (256 threads x float4)
HBM_COPY_BUFFERS = 7
HBM_COPY_TILE = 1024
# the fma_chain probe's constants: x <- fma(x, a, b), 8 per pass
FMA_CHAIN_A = 1.0000001
FMA_CHAIN_B = 1e-7
MUL_ADD_DECAY = 0.9999


def hbm_copy_ref(buffers):
    """Plain PyTorch version of :func:`hbm_copy` (same contract): ``x + 1``
    per buffer."""
    buffers = list(buffers)
    _check_copy_buffers(buffers)
    return [torch.add(x, 1.0) for x in buffers]


def mul_add_ref(a, b, c, passes: int = 256, tile: int = 256):
    """Plain PyTorch version of :func:`mul_add` (same contract): ``passes``
    times ``c = a * b + c * 0.9999`` in float32 eager ops, in the kernel's
    order (two multiplies, then the add).  ``tile`` shapes only the
    kernel's blocks."""
    _check_mul_add(a, b, c, passes, tile)
    out = c.clone()
    for _ in range(passes):
        out = a * b + out * MUL_ADD_DECAY
    return out


def _f32_value(x: float) -> float:
    """The float32 nearest ``x``, as a Python float."""
    return struct.unpack("<f", struct.pack("<f", x))[0]


def fma_chain_ref(x, passes: int = 256):
    """Plain PyTorch version of :func:`fma_chain` (same contract): each of
    the ``8 * passes`` steps ``x * a + b`` in float64 with the float32
    values of the constants, rounded to float32.  The product is exact in
    float64, so a step equals the kernel's fused multiply-add except where
    the sum's two roundings (to float64, then float32) differ from one:
    rarely, and by one float32 ulp."""
    _check_fma_chain(x, passes)
    a, b = _f32_value(FMA_CHAIN_A), _f32_value(FMA_CHAIN_B)
    out = x.clone()
    for _ in range(8 * passes):
        out = (out.double() * a + b).float()
    return out


def _check_copy_buffers(buffers):
    if len(buffers) != HBM_COPY_BUFFERS or buffers[0].dim() != 2:
        raise ValueError(f"the copy takes {HBM_COPY_BUFFERS} buffers: six [L, P] "
                         "planes and one [1, P] row")
    l, p = buffers[0].shape
    device = buffers[0].device
    for i, t in enumerate(buffers):
        shape = (l, p) if i + 1 < HBM_COPY_BUFFERS else (1, p)
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"copy buffer {i} must be float32 {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_mul_add(a, b, c, passes: int, tile: int):
    if a.dim() != 2:
        raise ValueError(f"mul_add takes [L, P] planes, got {tuple(a.shape)}")
    for t in (a, b, c):
        if t.shape != a.shape or t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"a, b and c must be float32 {tuple(a.shape)} on {a.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    l = a.shape[0]
    if passes < 0 or tile < 1 or 3 * l * tile * 4 > SMEM_OPT_IN_BYTES:
        raise ValueError(f"mul_add needs passes >= 0 and 3 * L * tile * 4 <= "
                         f"{SMEM_OPT_IN_BYTES} bytes of shared memory, got passes "
                         f"{passes}, L {l}, tile {tile}")


def _check_fma_chain(x, passes: int):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"fma_chain takes a float32 [L, P] plane, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if passes < 0:
        raise ValueError(f"passes must be >= 0, got {passes}")


def _check_launch_size(tensors):
    if any(t.numel() >= 2 ** 31 for t in tensors):
        raise ValueError("a probe buffer of 2^31 floats or more is too large for one launch")


def hbm_copy(buffers):
    """The copy probe: ``x + 1`` for each of seven buffers, in one launch.

    Args:
      buffers: six float32 ``[L, P]`` planes and one ``[1, P]`` row (the
      fused update's buffer set), contiguous, aligned to 16 bytes, on one
      device.

    Returns a list of seven new tensors, ``buffers[i] + 1``.
    """
    buffers = list(buffers)
    if buffers and buffers[0].device.type == "cpu":
        return hbm_copy_ref(buffers)
    _check_copy_buffers(buffers)
    device = require_cuda(*buffers)
    _check_launch_size(buffers)
    if any(b.data_ptr() % 16 for b in buffers):
        raise ValueError("the copy kernel takes buffers aligned to 16 bytes")
    outs = [torch.empty_like(b) for b in buffers]
    pointers = lambda ts: (ctypes.c_void_p * HBM_COPY_BUFFERS)(*(t.data_ptr() for t in ts))
    src, dst = pointers(buffers), pointers(outs)
    launch(
        "hbm_copy", device,
        ctypes.c_void_p(ctypes.addressof(src)), ctypes.c_void_p(ctypes.addressof(dst)),
        ctypes.c_int(buffers[0].numel()), ctypes.c_int(buffers[-1].numel()),
    )
    return outs


def mul_add(a, b, c, passes: int = 256, tile: int = 256):
    """The shared-memory stream probe: ``passes`` times
    ``c = a * b + c * 0.9999`` over ``[L, tile]`` tiles staged in shared
    memory, each pass reading ``a``, ``b`` and ``c`` there and writing
    ``c`` back.

    Args:
      a, b, c: float32 ``[L, P]``, contiguous, on one device; ``tile``:
      columns per block, with ``3 * L * tile * 4`` bytes at most 227 KB.

    Returns the new ``c`` ``[L, P]``.
    """
    if a.device.type == "cpu":
        return mul_add_ref(a, b, c, passes, tile)
    _check_mul_add(a, b, c, passes, tile)
    device = require_cuda(a, b, c)
    _check_launch_size((a,))
    l, p = a.shape
    out = torch.empty_like(c)
    launch(
        "mul_add", device, ptr(a), ptr(b), ptr(c), ptr(out),
        ctypes.c_int(l), ctypes.c_int(p), ctypes.c_int(tile), ctypes.c_int(passes),
    )
    return out


def fma_chain(x, passes: int = 256):
    """The FMA probe: ``8 * passes`` dependent fused multiply-adds
    ``x = fma(x, 1.0000001, 1e-7)`` per element, in registers.

    Args:
      x: float32 ``[L, P]``, contiguous.

    Returns the new ``[L, P]`` values.
    """
    if x.device.type == "cpu":
        return fma_chain_ref(x, passes)
    _check_fma_chain(x, passes)
    device = require_cuda(x)
    _check_launch_size((x,))
    out = torch.empty_like(x)
    launch("fma_chain", device, ptr(x), ptr(out),
           ctypes.c_int(x.numel()), ctypes.c_int(passes))
    return out
