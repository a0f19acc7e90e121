"""fastslam_tpu_torch: the FastSLAM engine of ``fastslam_tpu`` in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The JAX package ``fastslam_tpu`` is the reference this package is tested
against; this package imports neither it nor JAX.  Importing it builds no
kernel: ``core/_build.py`` compiles ``csrc/*.cu`` at the first launch on a
CUDA tensor.

The top-level names are the JAX package's, each from this package's own
modules: the reference facade (``FastSLAM2``, ``LineFilter``,
``HoughTransformation``, ``ICP``, ``GeometryUtils``, ``LandmarkUtils``,
``Robot``, ``EvaluationUtils``, ``Serializer``, the models) and the engine's
(its configuration, the blocks state and step, ``run_driver``,
``HALDriver``).
"""

# reference-compatible surface
from fastslam_tpu_torch.api import (
    FastSLAM2, GeometryUtils, HoughTransformation, ICP, LandmarkUtils, LineFilter,
)
from fastslam_tpu_torch.drivers.robot import EvaluationUtils, Robot, Serializer
from fastslam_tpu_torch.models import DirectedPoint, Landmark, Measurement, Particle, Point

# engine-native surface
from fastslam_tpu_torch.app.runner import run_driver
from fastslam_tpu_torch.config import DEFAULT_CONFIG, FastSLAMConfig
from fastslam_tpu_torch.core.kernels import fastslam_step
from fastslam_tpu_torch.core.state import FilterState, Measurements, init_state, pad_measurements
from fastslam_tpu_torch.drivers.jderobot_hal import HALDriver

__all__ = [
    # reference-compatible
    "FastSLAM2",
    "HoughTransformation",
    "ICP",
    "LineFilter",
    "DirectedPoint",
    "Landmark",
    "Measurement",
    "Particle",
    "Point",
    "GeometryUtils",
    "LandmarkUtils",
    "Robot",
    "EvaluationUtils",
    "Serializer",
    # engine-native
    "DEFAULT_CONFIG",
    "FastSLAMConfig",
    "FilterState",
    "Measurements",
    "init_state",
    "pad_measurements",
    "fastslam_step",
    "run_driver",
    "HALDriver",
]

__version__ = "0.1.0"
