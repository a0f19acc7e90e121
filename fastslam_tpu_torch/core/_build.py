"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles ``csrc/fused_update.cu`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with :mod:`ctypes` (no
PyTorch headers, so a build takes seconds).  The build runs at first use,
into ``build/kernels/`` beside the package, keyed by a hash of the source and
the flags; the ``ptxas -v`` report (registers, shared memory, spills) is kept
beside the library as ``.log``.

Nothing here runs on import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fused_update.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# -fmad=false: no contraction into multiply-adds, so the kernels round op for
# op like the plain PyTorch versions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "fused_update_planes_launch": [_I] + [_P] * 14 + [_I] * 4
    + [_F, _I, _F, _F, _F, _I, _P],
    "fused_update_planes_multi_launch": [_I] + [_P] * 22 + [_I] * 5
    + [_F, _I, _F, _F, _F, _I, _P],
}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from the CUDA toolkit PyTorch found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"fused_update_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for this source already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build finds a whole file
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fastslam_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fastslam_cuda_error_string.restype = ctypes.c_char_p
    return lib


def error_string(code: int) -> str:
    return f"{code} ({load().fastslam_cuda_error_string(code).decode()})"
