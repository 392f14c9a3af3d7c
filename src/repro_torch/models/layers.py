"""Shared layers: an initializer on a ``torch.Generator``, norms, embeddings,
MLPs, RoPE.

Port of ``repro.models.layers`` for the dense decoder.  Parameters are plain
dictionaries of tensors with the reference's tree layout; the reference's
logical partition specs have no counterpart on one card and are dropped.
The arithmetic follows the reference: ``rms_norm`` upcasts to float32 with
eps 1e-6, ``unembed`` runs in float32, RoPE rotates split halves (not
interleaved pairs), and ``gelu`` is the tanh approximation that
``jax.nn.gelu`` computes by default.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GATED_ACTS = ("swiglu", "geglu")


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (a ``ModelConfig`` dtype name) -> torch."""
    if isinstance(name, torch.dtype):
        return name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(name)]


class Initializer:
    """Seeded parameter factory on a ``torch.Generator``.

    ``normal`` draws float32 normals on ``device`` and casts them to the
    parameter dtype.  A leading group axis ``g`` (the stacked layers of a
    stage) may be given; the default scale is ``1/sqrt(fan_in)`` of the
    per-layer shape, whatever the group axis.
    """

    def __init__(self, seed: int, dtype, device: torch.device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.dtype = torch_dtype(dtype)

    def normal(self, shape, scale: float | None = None, g: int = 0,
               dtype=None) -> torch.Tensor:
        shape = tuple(shape)
        scale = 1.0 / math.sqrt(shape[0]) if scale is None else scale
        full = ((g,) if g else ()) + shape
        v = torch.randn(full, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return v.mul_(scale).to(torch_dtype(dtype) if dtype else self.dtype)

    def ones(self, shape, g: int = 0, dtype=None) -> torch.Tensor:
        full = ((g,) if g else ()) + tuple(shape)
        return torch.ones(full, dtype=torch_dtype(dtype) if dtype else self.dtype,
                          device=self.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def init_rms_norm(init: Initializer, d: int, g: int = 0):
    return {"scale": init.ones((d,), g=g, dtype="float32")}


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(init: Initializer, vocab: int, d: int):
    return {"table": init.normal((vocab, d), scale=1.0)}


def embed(tokens: torch.Tensor, table: torch.Tensor, compute_dtype):
    return table.to(torch_dtype(compute_dtype))[tokens.long()]


def unembed(x: torch.Tensor, table: torch.Tensor):
    # logits in f32 for a stable softmax/xent
    return x.float() @ table.float().T


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(init: Initializer, d: int, f: int, act: str, g: int = 0):
    p = {"down": init.normal((f, d), g=g)}
    if act in GATED_ACTS:
        p["gate"] = init.normal((d, f), g=g)
    p["up"] = init.normal((d, f), g=g)
    return p


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp(x: torch.Tensor, p: dict, act: str):
    if act in GATED_ACTS:
        gate_fn = F.silu if act == "swiglu" else _gelu
        h = gate_fn(x @ p["gate"].to(x.dtype)) * (x @ p["up"].to(x.dtype))
    elif act == "sqrelu":  # nemotron-4: squared ReLU
        h = torch.square(F.relu(x @ p["up"].to(x.dtype)))
    elif act == "gelu":
        h = _gelu(x @ p["up"].to(x.dtype))
    else:
        raise ValueError(act)
    return h @ p["down"].to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, base: float, device=None):
    half = d_head // 2
    return base ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float):
    """x: (..., T, H, D); positions: (..., T) int32."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, base, x.device)  # (D/2,)
    angles = positions[..., :, None, None].float() * freqs  # (..., T, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
