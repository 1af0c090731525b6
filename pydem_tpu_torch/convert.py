"""Carry state planes from numpy (e.g. ``np.asarray`` of the JAX package's
outputs) into the port's tensors."""
from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(arrays, device, dtype):
    """``{name: ndarray}`` → ``{name: tensor on device}``.

    The system has no weights; its state is planes such as ``elev``, ``dX``,
    ``dY``, ``dX2``, ``dY2``, ``W``, ``K``, ``W1``, ``base`` and a padded
    canvas.  Floating planes become ``dtype``; integer and bool planes keep
    their dtype.  ``None`` (a stage that has not run) and scalars (such as
    ``twi_min_area`` and ``uca_sweeps``) pass through as host values.
    """
    out = {}
    for name, a in arrays.items():
        if a is None or np.ndim(a) == 0:
            out[name] = a if a is None else np.asarray(a).item()
            continue
        a = np.asarray(a)
        t = torch.tensor(a)  # a copy: JAX's host arrays are read-only
        if a.dtype.kind == "f":
            t = t.to(dtype)
        out[name] = t.to(device)
    return out


# a processor's state: the planes a stage leaves behind, and its two scalars
STATE_FIELDS = ("elev", "mag", "direction", "flats", "section", "proportion",
                "uca", "twi", "edge_todo", "edge_done")
STATE_SCALARS = ("twi_min_area", "uca_sweeps")


def processor_state(dp):
    """The state of a ``DEMProcessor`` (this package's or the JAX package's)
    as ``{name: ndarray, scalar or None}``: :data:`STATE_FIELDS`,
    :data:`STATE_SCALARS` and the pixel vectors."""
    state = {k: getattr(dp, k, None) for k in STATE_FIELDS + STATE_SCALARS}
    state.update({k: getattr(dp, k) for k in ("dX", "dY", "dX2", "dY2")})
    return {k: v if v is None or np.ndim(v) == 0 else np.array(v)
            for k, v in state.items()}


def processor_from_state(state, device="cuda", **config):
    """A :class:`pydem_tpu_torch.api.DEMProcessor` set up at the point where
    ``state`` (see :func:`processor_state`) was taken: after any stage of a
    JAX ``DEMProcessor``, the port's processor goes on from there (for
    example into ``calc_uca(uca_init=...)``).  The planes are host arrays,
    as a processor holds them between stages of the host-state route."""
    from .api import DEMProcessor

    dp = DEMProcessor(elev=np.array(state["elev"], "float64"),
                      dX=np.asarray(state["dX"]), dY=np.asarray(state["dY"]),
                      dX2=np.asarray(state["dX2"]),
                      dY2=np.asarray(state["dY2"]), device=device, **config)
    for k in STATE_FIELDS[1:]:
        v = state.get(k)
        if v is not None:
            setattr(dp, k, np.array(v))
    if state.get("twi_min_area") is not None:
        dp.twi_min_area = float(state["twi_min_area"])
    if state.get("uca_sweeps") is not None:
        dp.uca_sweeps = int(state["uca_sweeps"])
    return dp
