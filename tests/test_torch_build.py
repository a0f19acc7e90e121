"""The kernel build and its ctypes binding, checked without a GPU.

* The cached library is keyed on every file under ``csrc/`` and the flags,
  so an edit to a header or to any source builds anew.
* The argument types ``core/_build.py`` declares for each launcher match the
  launcher's C signature in ``csrc/``.
* Each wrapper passes its launcher exactly the arguments, and argument
  types, that the signature declares (the launch itself is faked).
"""

import ctypes
import re
import shutil

import pytest
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import _build, cuda_kernels

torch.set_num_threads(1)


def test_library_key_follows_every_csrc_file(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    base = _build.source_digest(csrc)
    assert base == _build.source_digest(_build.CSRC)
    files = sorted(p for p in csrc.iterdir() if p.is_file())
    assert {p.suffix for p in files} == {".cu", ".cuh"}
    for path in files:
        original = path.read_bytes()
        path.write_bytes(original + b"\n")
        assert _build.source_digest(csrc) != base, path.name
        path.write_bytes(original)
        assert _build.source_digest(csrc) == base
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.source_digest(csrc) != base
    assert [p.name for p in _build.sources(csrc)] == ["fused_fs2.cu", "fused_update.cu",
                                                      "icp_nn.cu", "probes.cu",
                                                      "ring_halo.cu"]
    assert _build.source_digest(_build.CSRC) in _build.library_path().name


def c_signatures():
    """``{launcher: [ctypes type per parameter]}`` from the C sources."""
    ctype = lambda decl: (ctypes.c_void_p if "*" in decl else
                          ctypes.c_float if decl.split()[0] == "float" else ctypes.c_int)
    out = {}
    for src in _build.sources():
        text = src.read_text()
        for name, params in re.findall(r"\nint (\w+_launch)\(([^)]*)\)", text):
            out[name] = [ctype(p.strip()) for p in params.split(",")]
    return out


def test_signatures_match_the_launchers_in_csrc():
    assert c_signatures() == _build._SIGNATURES


P, L, M, C = 64, 8, 4, 3


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def wrapper_calls(cfg):
    planes = [meta(L, P) for _ in range(4)]
    state = (meta(P), *planes, None, meta(L, P), meta(P, dtype=torch.int32))
    tick = (meta(M, 2), meta(M, dtype=torch.bool))
    chunk = (meta(C, M, 2), meta(C, M, dtype=torch.bool))
    return {
        "fused_update_planes": lambda: cuda_kernels.fused_update_planes(
            meta(P, 3), *state, *tick, cfg),
        "fused_update_planes_multi": lambda: cuda_kernels.fused_update_planes_multi(
            meta(P, 3), *state, *chunk, meta(C, P), meta(C, P), cfg),
        "fused_fs2_planes": lambda: cuda_kernels.fused_fs2_planes(
            meta(P, 3), *state, *tick, meta(P, 3), 1e-4, 1e-4, 1e-4, cfg,
            evidence_scale=0.37),
        "fused_fs2_planes_multi": lambda: cuda_kernels.fused_fs2_planes_multi(
            meta(P, 3), *state, *chunk, meta(C, 3, P), meta(C), meta(C), meta(C),
            meta(C), 1e-4, cfg),
        "icp_correspondences": lambda: cuda_kernels.icp_correspondences(
            meta(C, P, 2), meta(C, M, 2), meta(C, M, dtype=torch.bool)),
        "icp_point_to_line": lambda: cuda_kernels.icp_point_to_line_fused(
            meta(C, P, 2), meta(C, M, 2), meta(C, P, dtype=torch.bool),
            meta(C, M, dtype=torch.bool), meta(C, M, 2), meta(C, M, dtype=torch.bool),
            100, 1e-5),
        "icp_sin_cos": lambda: cuda_kernels.icp_rotation_sin_cos(meta(P)),
        "ring_halo_exchange": lambda: cuda_kernels.ring_halo_exchange(
            [meta(P, 3 + 1 + 6 * L + 1) for _ in range(C)]),
        "hbm_copy": lambda: cuda_kernels.hbm_copy([meta(L, P) for _ in range(6)]
                                                  + [meta(1, P)]),
        "mul_add": lambda: cuda_kernels.mul_add(meta(L, P), meta(L, P), meta(L, P),
                                                passes=3, tile=32),
        "fma_chain": lambda: cuda_kernels.fma_chain(meta(L, P), passes=3),
    }


@pytest.mark.parametrize("name", sorted(cuda_kernels.LAUNCHES))
def test_wrappers_pass_what_the_signatures_declare(monkeypatch, name):
    class FakeLibrary:
        def __getattr__(self, fn):
            return fn

    calls = []
    monkeypatch.setattr(cuda_kernels, "_require_cuda", lambda *t: torch.device("meta"))
    monkeypatch.setattr(cuda_kernels, "_launch",
                        lambda fn, device, *args: calls.append((fn, args)))
    monkeypatch.setattr(_build, "load", lambda: FakeLibrary())
    launches = dict(cuda_kernels.LAUNCHES)
    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                         parity_mode=False)
    wrapper_calls(cfg)[name]()
    (fn, args), = calls
    assert fn == f"{name}_launch"
    # the device index comes first and the stream last, both added by _launch
    declared = _build._SIGNATURES[fn][1:-1]
    assert [type(a) for a in args] == declared
    assert cuda_kernels.LAUNCHES[name] == launches[name] + 1
    cuda_kernels.LAUNCHES[name] = launches[name]
