"""fastslam_tpu_torch: the FastSLAM engine of ``fastslam_tpu`` in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The JAX package ``fastslam_tpu`` is the reference this package is tested
against; this package imports neither it nor JAX.  Importing it builds no
kernel: ``core/_build.py`` compiles ``csrc/*.cu`` at the first launch on a
CUDA tensor.
"""

__version__ = "0.1.0"
