"""fastslam_tpu_torch: the FastSLAM engine of ``fastslam_tpu`` in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The JAX package ``fastslam_tpu`` is the reference this package is tested
against; this package imports neither it nor JAX.  Importing it builds no
kernel: ``core/_build.py`` compiles ``csrc/*.cu`` at the first launch on a
CUDA tensor.

The top-level names are the JAX package's: the reference facade (``Robot``,
``EvaluationUtils``, ``Serializer``, the models), the engine's entry points
(``run_driver``, ``HALDriver``) and its configuration.
"""

from fastslam_tpu_torch.app.runner import run_driver
from fastslam_tpu_torch.config import DEFAULT_CONFIG, FastSLAMConfig
from fastslam_tpu_torch.drivers.jderobot_hal import HALDriver
from fastslam_tpu_torch.drivers.robot import EvaluationUtils, Robot, Serializer
from fastslam_tpu_torch.models import DirectedPoint, Landmark, Measurement, Particle, Point

__all__ = [
    "DirectedPoint",
    "Landmark",
    "Measurement",
    "Particle",
    "Point",
    "Robot",
    "EvaluationUtils",
    "Serializer",
    "DEFAULT_CONFIG",
    "FastSLAMConfig",
    "run_driver",
    "HALDriver",
]

__version__ = "0.1.0"
