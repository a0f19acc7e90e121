"""The port's configuration and package boundary.

* ``FastSLAMConfig`` holds the JAX one field for field (names and defaults),
  less the fields the port leaves out on purpose.
* Importing the port, or any module of the slice, loads neither JAX nor the
  JAX package (checked in a fresh interpreter).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.interop import JAX_ONLY_CONFIG_FIELDS, config_from_jax_fields

torch.set_num_threads(1)

EXCLUDED = {"use_pallas", "pallas_interpret", "engine", "fs2_reuse_association"}

SLICE_MODULES = [
    "fastslam_tpu_torch",
    "fastslam_tpu_torch.__main__",
    "fastslam_tpu_torch.config",
    "fastslam_tpu_torch.interop",
    "fastslam_tpu_torch.core.state",
    "fastslam_tpu_torch.core.kernels",
    "fastslam_tpu_torch.core.cuda_kernels",
    "fastslam_tpu_torch.core._build",
    "fastslam_tpu_torch.frontend.line_filter",
    "fastslam_tpu_torch.frontend.hough",
    "fastslam_tpu_torch.frontend.clustering",
    "fastslam_tpu_torch.frontend.pipeline",
    "fastslam_tpu_torch.drivers.base",
    "fastslam_tpu_torch.drivers.sim_world",
    "fastslam_tpu_torch.drivers.replay",
    "fastslam_tpu_torch.eval.metrics",
    "fastslam_tpu_torch.app.runner",
    "fastslam_tpu_torch.app.cli",
]


def test_config_fields_match_jax_less_exclusions():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(FastSLAMConfig)}
    assert set(jax_fields) - set(port_fields) == EXCLUDED
    assert set(port_fields) <= set(jax_fields)
    for name, default in port_fields.items():
        assert default == jax_fields[name], name
    assert JAX_ONLY_CONFIG_FIELDS == EXCLUDED


def test_config_from_jax_fields_round_trips():
    jcfg = JaxConfig(num_particles=300, max_landmarks=48, parity_mode=False,
                     use_pallas=True, engine="planes")
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    assert cfg.num_particles == 300 and cfg.max_landmarks == 48
    assert not cfg.parity_mode
    assert cfg.measurement_cov == jcfg.measurement_cov
    assert cfg.min_line_angle_rad == jcfg.min_line_angle_rad
    with pytest.raises(ValueError, match="does not know"):
        config_from_jax_fields({"num_particles": 3, "not_a_field": 1})


def test_slice_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {SLICE_MODULES!r}:
            if name.endswith("__main__"):
                continue  # running it parses arguments; its import is cli's
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "fastslam_tpu" or m.startswith("fastslam_tpu."))
        print(",".join(bad))
        """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"slice imported: {out.stdout.strip()}"


def test_package_sources_name_neither_jax_nor_the_jax_package():
    """No module of the port imports JAX or the JAX package, even lazily."""
    import fastslam_tpu_torch

    root = os.path.dirname(fastslam_tpu_torch.__file__)
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                for line in open(path):
                    s = line.strip()
                    if s.startswith(("import ", "from ")) and (
                            " jax" in s or " fastslam_tpu." in s or s.endswith(" fastslam_tpu")):
                        offenders.append(f"{path}: {s}")
    assert not offenders, offenders


def test_fs2_config_fields_carry_across():
    """The fields the FastSLAM 2.0 path reads come across from a JAX config."""
    jcfg = JaxConfig(parity_mode=False, proposal_mode="fastslam2",
                     proposal_xy_floor=0.02, proposal_theta_floor=0.005,
                     fs2_evidence_weights=True, fs2_mode_dial=False,
                     fs2_dial_lo_floor=2e-3, fs2_dial_hi_floor=5e-3,
                     translation_noise=0.01, rotation_noise=0.002,
                     use_pallas=True, fs2_reuse_association=True)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    for name in ("parity_mode", "proposal_mode", "proposal_xy_floor",
                 "proposal_theta_floor", "fs2_evidence_weights", "fs2_mode_dial",
                 "fs2_dial_lo_floor", "fs2_dial_hi_floor", "translation_noise",
                 "rotation_noise"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert not hasattr(cfg, "fs2_reuse_association")   # the retired lever
