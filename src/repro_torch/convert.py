"""Carry state across from the JAX package to the port.

Data takes the place of weights in the paper's pipeline: a replay lane's
state is its cache (:class:`~repro_torch.cache.flat.FlatState`) and a
simulator lane's input is its compiled network
(:class:`~repro_torch.core.simspec.SimSpec`).  The model wing has weights:
:func:`transformer_params_from_numpy` takes the reference transformer's
parameter tree.  These functions take the JAX package's structures *as
numpy arrays* (for example ``jax.tree.map(np.asarray, state)``) and return
the port's tensors, so a run can be handed over mid-stream and both sides
continued.  Nothing here imports the JAX package: fields are read by name.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cache.flat import FlatState
from repro_torch.core.simspec import SimSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import build_stages, check_supported


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


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    """A numpy array -> a tensor of the same dtype (bfloat16 included:
    numpy holds it as ml_dtypes' ``bfloat16``, read here bit for bit)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def transformer_params_from_numpy(tree: Any, cfg: ModelConfig,
                                  device: str = "cuda") -> dict:
    """The reference transformer's parameters (``param_values`` of
    ``repro.models.transformer.init_params``, every leaf a numpy array) ->
    the port's parameter dictionary, each leaf in its own dtype.

    The tree layout is the same on both sides: ``embed``, ``final_norm``,
    ``unembed`` (untied), and ``stages``, one tuple of block dictionaries
    per stage whose leaves carry the stage's group axis first (an rwkv6
    block: ``ln1``, ``rwkv``, ``ln2``, its norms unused, as in the
    reference).
    """
    check_supported(cfg)
    dev = resolve_device(device)
    stages = build_stages(cfg)
    if len(tree["stages"]) != len(stages):
        raise ValueError(f"{len(tree['stages'])} stages in the tree, "
                         f"{len(stages)} in {cfg.name}'s plan")

    def conv(node, g=None):
        if isinstance(node, dict):
            return {k: conv(v, g) for k, v in node.items()}
        t = _tensor(node, dev)
        if g is not None and t.shape[0] != g:
            raise ValueError(f"a stage leaf of shape {tuple(t.shape)} lacks "
                             f"the stage's group axis {g}")
        return t

    out = {k: conv(v) for k, v in tree.items() if k != "stages"}
    out["stages"] = []
    for (g, pattern), stage in zip(stages, tree["stages"]):
        if len(stage) != len(pattern):
            raise ValueError(f"a stage holds {len(stage)} blocks, its pattern "
                             f"{len(pattern)}")
        out["stages"].append(tuple(conv(bp, g) for bp in stage))
    return out
