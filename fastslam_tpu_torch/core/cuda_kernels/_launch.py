"""The one launch path of the kernel wrappers (:func:`launch`, on the
library ``core/_build.py`` loads) and the count of launches it keeps in
:data:`LAUNCHES`: of a block of code (:func:`counted`), and of a CUDA graph,
whose capture launches nothing and whose every replay launches what the
capture enqueued (:func:`captured`, :func:`replay`)."""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, Optional

import torch

from fastslam_tpu_torch.core import _build

# launches per kernel, keyed by the name of its launcher less ``_launch``
LAUNCHES: Dict[str, int] = {name[:-len("_launch")]: 0 for name in _build._SIGNATURES
                            if name.endswith("_launch")}

# shared memory a block may opt into (csrc/probes.cu SMEM_OPT_IN_LIMIT)
SMEM_OPT_IN_BYTES = 232_448


def require_cuda(*tensors):
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return device


def ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` (``<name>_launch`` of the library) with
    ``args`` on the current stream of ``device``: the device index goes
    first and the stream last; a non-zero return code raises.  Counted."""
    fn = getattr(_build.load(), f"{name}_launch")
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(ctypes.c_int(device.index if device.index is not None
                         else torch.cuda.current_device()),
            *args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"CUDA kernel launch failed: {_build.error_string(rc)}")
    LAUNCHES[name] += 1


@contextlib.contextmanager
def counted() -> Iterator[Dict[str, int]]:
    """Yields a dict that, once the block ends, holds the launches of each
    kernel the block launched (kernels it did not launch are absent)."""
    before = dict(LAUNCHES)
    launches: Dict[str, int] = {}
    yield launches
    launches.update({k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]})


@contextlib.contextmanager
def captured() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph capture: yields a dict that, once the block
    ends, holds the launches of one replay of the graph.  The capture itself
    launched nothing, so its counts are taken back out of ``LAUNCHES``."""
    with counted() as tally:
        yield tally
    for name, n in tally.items():
        LAUNCHES[name] -= n


def replay(graph: torch.cuda.CUDAGraph, tally: Dict[str, int]) -> None:
    """One replay of a captured graph, its launches (``tally``, from
    :func:`captured`) counted."""
    graph.replay()
    for name, n in tally.items():
        LAUNCHES[name] += n
