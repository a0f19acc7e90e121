"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into one shared
library with a plain C interface, loaded with :mod:`ctypes` (no
PyTorch headers, so a build takes seconds).  The build runs at first use,
into ``build/kernels/`` beside the package, keyed by a hash of every file
under ``csrc/`` (sources and headers) and the flags; the ``ptxas -v`` report
(registers, shared memory, spills) is kept beside the library as ``.log``.

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
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# -fmad=false: no contraction into multiply-adds, so the kernels round op for
# op like the plain PyTorch versions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "fused_update_planes_launch": [_I] + [_P] * 14 + [_I] * 4
    + [_F, _I, _F, _F, _F, _I, _I, _P],
    "fused_update_planes_multi_launch": [_I] + [_P] * 20 + [_I] * 5
    + [_F, _I, _F, _F, _F, _I, _I, _P],
    "fused_fs2_planes_launch": [_I] + [_P] * 16 + [_I] * 4
    + [_F, _I, _F, _F, _F, _I, _I, _P],
    "fused_fs2_planes_multi_launch": [_I] + [_P] * 20 + [_I] * 5
    + [_F, _I, _F, _F, _F, _I, _I, _P],
    "icp_correspondences_launch": [_I] + [_P] * 5 + [_I] * 3 + [_P],
    "icp_point_to_line_launch": [_I] + [_P] * 11 + [_I] * 5 + [_F, _I, _I, _P],
    "icp_sin_cos_launch": [_I] + [_P] * 3 + [_I, _P],
    "ring_halo_exchange_launch": [_I] + [_P] * 3 + [_I] * 2 + [_P],
    "hbm_copy_launch": [_I] + [_P] * 2 + [_I] * 2 + [_P],
    "mul_add_launch": [_I] + [_P] * 4 + [_I] * 4 + [_P],
    "fma_chain_launch": [_I] + [_P] * 2 + [_I] * 2 + [_P],
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


def sources(csrc: Path = CSRC) -> list[Path]:
    """The translation units: every ``.cu`` file, in name order."""
    return sorted(csrc.glob("*.cu"))


def source_digest(csrc: Path = CSRC) -> str:
    """Hash of every file under ``csrc`` (name and bytes) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(path.relative_to(csrc).as_posix().encode() + b"\0")
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"fastslam_kernels_{source_digest()}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    srcs = sources()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    reports = [proc.communicate()[0] for proc in procs]
    failed = [(src.name, proc.returncode, text)
              for src, proc, text in zip(srcs, procs, reports) if proc.returncode]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{text}" for name, rc, text in failed))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(reports))
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
