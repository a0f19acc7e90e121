"""The hand-written CUDA kernels and their plain PyTorch versions, counterpart
of ``fastslam_tpu/core/pallas_kernels.py``: one module per kernel family,
named after its source under ``csrc/`` (``filter`` holds rows 1-4), each
launching through :mod:`._launch`; ``core/_build.py`` builds them.  Every
public name of a family is exported here (``segment_sum`` is the wrapper,
not its module); a sweep sets a launch geometry such as ``FS2_TILE`` on
the family module, where the wrapper reads it.

Each wrapper dispatches on the device of the tensors it is given:

* CUDA tensors launch the kernel, or raise.  There is no fallback.
* CPU tensors run the plain version (``*_ref``), which mirrors the kernel
  operation for operation on ``[L, P]`` tensors.

The four filter kernels update the landmark planes and ``lm_count`` in
place (each particle owns its column, so a kernel needs no second buffer);
the per-tick wrappers also update ``log_weights`` in place.  Callers that need the inputs
afterwards pass clones.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that it
went through the kernels; the plain versions never touch it.  A block's
launches are counted by :func:`counted`, a CUDA graph's by :func:`captured`
and :func:`replay`.
"""

import importlib
import types

from fastslam_tpu_torch.core.cuda_kernels._launch import LAUNCHES, captured, counted, replay

# every public name a family defines, as ``cuda_kernels.<name>``
for _family in ("filter", "icp", "ring", "probes", "segment_sum", "resample", "deflate"):
    _module = importlib.import_module(f"{__name__}.{_family}")
    globals().update((name, value) for name, value in vars(_module).items()
                     if not name.startswith("_") and not isinstance(value, types.ModuleType)
                     and getattr(value, "__module__", _module.__name__) == _module.__name__)
