"""Checkpoint and resume of the full filter state.

Counterpart of ``fastslam_tpu/io/checkpoint.py``, in its ``.npz`` format
(``format_version`` 1, the same field names), so a checkpoint the JAX
package wrote loads here with the same arrays.  Either layout is saved as it
is: a :class:`~fastslam_tpu_torch.core.state.PlanesState` (``layout`` =
``"planes"``, the ``[L, P]`` planes under their names, no ``lm_cc`` in
production) or a :class:`~fastslam_tpu_torch.core.state.FilterState`
(``lm_mean``, ``lm_cov``), with the loop's iteration counter and
dead-reckoned pose.  The write is atomic: a temporary file in the target's
directory, then ``os.replace``.

The port keeps its randomness in a :class:`torch.Generator`, not in the
state: :func:`save_checkpoint` stores the generator's state
(``torch_generator_state``) and :func:`load_checkpoint` returns a generator
that continues its stream.  A JAX checkpoint carries a threefry key
(``rng_key_data``) instead; the port seeds a fresh generator from it, so the
resumed draws differ from the ones JAX would take.  So that the JAX
package's loader, which reads that key unconditionally, takes a port
checkpoint too, :func:`save_checkpoint` also writes a key: the generator's
initial seed split into two 32-bit words, as ``jax.random.PRNGKey`` splits a
64-bit seed (zeros without a generator).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from fastslam_tpu_torch.core.state import FilterState, PlanesState

_FORMAT_VERSION = 1

_PLANE_FIELDS = ("lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cc", "lm_cd")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _threefry_key(generator: Optional[torch.Generator]) -> np.ndarray:
    """``uint32[2]``: the generator's initial seed as (high word, low word),
    the key ``jax.random.PRNGKey`` makes of a 64-bit seed; zeros for None."""
    seed = 0 if generator is None else generator.initial_seed() % 2 ** 64
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def save_checkpoint(path: str, state, *, iteration: int = 0, robot_pose=None,
                    extra: Optional[dict] = None,
                    generator: Optional[torch.Generator] = None) -> None:
    """Atomically write the filter state (either layout), the loop state, a
    threefry key for the JAX package's loader and, when given, the
    generator's state."""
    arrays = {
        "format_version": np.int32(_FORMAT_VERSION),
        "poses": _host(state.poses),
        "log_weights": _host(state.log_weights),
        "lm_count": _host(state.lm_count),
        "rng_key_data": _threefry_key(generator),
        "iteration": np.int64(iteration),
        "robot_pose": np.asarray(robot_pose if robot_pose is not None else np.zeros(3)),
    }
    if generator is not None:
        arrays["torch_generator_state"] = _host(generator.get_state())
    if isinstance(state, PlanesState):
        arrays["layout"] = np.asarray("planes")
        for f in _PLANE_FIELDS:
            v = getattr(state, f)
            if v is not None:   # production states carry no cc plane (cc == cb)
                arrays[f] = _host(v)
    else:
        arrays["lm_mean"] = _host(state.lm_mean)
        arrays["lm_cov"] = _host(state.lm_cov)
    for k, v in (extra or {}).items():
        arrays["extra_" + k] = np.asarray(v)

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _generator(z, device: torch.device) -> Optional[torch.Generator]:
    """The saved generator; one seeded from a JAX checkpoint's threefry key
    (a new stream); None when the checkpoint holds neither."""
    gen = torch.Generator(device=device)
    if "torch_generator_state" in z.files:
        gen.set_state(torch.from_numpy(z["torch_generator_state"]))
    elif "rng_key_data" in z.files:
        key = np.ascontiguousarray(z["rng_key_data"]).tobytes()
        gen.manual_seed(int.from_bytes(key[:8].ljust(8, b"\0"), "little"))
    else:
        return None
    return gen


def load_checkpoint(path: str, device: torch.device | str = "cuda"):
    """Returns ``(state, meta)``: the state in the layout it was saved in, on
    ``device``, and ``meta`` with ``iteration``, ``robot_pose``, ``extra``
    and ``generator`` (a :class:`torch.Generator` on ``device``: the saved
    one, else one seeded from the threefry key; None when the checkpoint
    holds neither)."""
    device = torch.device(device)
    with np.load(path) as z:
        version = int(z["format_version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        t = lambda name: torch.from_numpy(z[name]).to(device)
        if "layout" in z.files and str(z["layout"]) == "planes":
            state = PlanesState(
                poses=t("poses"), log_weights=t("log_weights"), lm_count=t("lm_count"),
                **{f: (t(f) if f in z.files else None) for f in _PLANE_FIELDS})
        else:
            state = FilterState(poses=t("poses"), log_weights=t("log_weights"),
                                lm_mean=t("lm_mean"), lm_cov=t("lm_cov"),
                                lm_count=t("lm_count"))
        meta = {
            "iteration": int(z["iteration"]),
            "robot_pose": np.asarray(z["robot_pose"]),
            "extra": {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")},
            "generator": _generator(z, device),
        }
    return state, meta
