"""Carry state across from the JAX package to the port.

Data takes the place of weights in this system: a replay lane's state is
its cache (:class:`~repro_torch.cache.flat.FlatState`) and a simulator
lane's input is its compiled network
(:class:`~repro_torch.core.simspec.SimSpec`).  These functions take the JAX
package's NamedTuples of the same name *as numpy arrays* (for example
``jax.tree.map(np.asarray, state)``) and return the port's tensors, so a
run can be handed over mid-stream and both sides continued.  Nothing here
imports the JAX package: the fields are read by name.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cache.flat import FlatState
from repro_torch.core.simspec import SimSpec


def flat_state_from_numpy(state: Any, device: str = "cuda") -> FlatState:
    """A JAX ``FlatState`` (numpy fields) -> the port's lane-batched state.

    Unbatched fields (one lane: ``key2slot`` is ``(K,)``) gain a leading
    lane axis; stacked ones (``(L, K)``) keep theirs.
    """
    dev = resolve_device(device)
    fields = [np.asarray(getattr(state, f), dtype=np.int32)
              for f in FlatState._fields]
    if fields[0].ndim == 1:
        fields = [a[None] for a in fields]
    if len({a.shape[0] for a in fields}) != 1:
        raise ValueError("FlatState fields disagree on the lane count")
    # copies: the port updates its state in place
    return FlatState(*[torch.tensor(a, device=dev) for a in fields])


def spec_from_numpy(spec: Any, device: str = "cuda") -> SimSpec:
    """A JAX ``SimSpec`` (numpy fields, one p_hit or stacked) -> the port's."""
    dev = resolve_device(device)
    dtypes = {"is_queue": np.bool_, "svc_ns": np.float32,
              "dist_id": np.int32, "dist_params": np.float32,
              "branch_cum": np.float32, "visits": np.int32,
              "servers": np.int32, "disk_rank": np.int32}
    arrays = {f: torch.tensor(np.asarray(getattr(spec, f), dtype=dt),
                              device=dev)
              for f, dt in dtypes.items()}
    return SimSpec(**arrays, mpl=int(spec.mpl))
