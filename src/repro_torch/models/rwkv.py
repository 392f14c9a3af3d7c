"""RWKV6 ("Finch") blocks — attention-free, data-dependent decay.

Port of ``repro.models.rwkv``.  Time-mix: a data-dependent token shift
(ddlerp with a rank-32 LoRA) feeding the r/k/v/g/w projections; the WKV6
recurrence keeps a per-head ``(dh x dh)`` float32 state with a
per-channel decay w_t = exp(-exp(x)), x clipped to [-8, 4]
(arXiv:2404.05892).  Channel-mix: a squared-ReLU FFN with receptance
gating.

The recurrence is :func:`_wkv_scan`: on the card the hand-written WKV
kernel (``repro_torch.kernels.linear_scan``) with the state in and out,
where the reference runs a ``lax.scan``; on the CPU the kernel's plain
version.  Prefill and decode differ only in T.  A state that is given is
updated in place: ``wkv`` by the scan, while :func:`rwkv_block` returns the
new ``x_prev_att`` / ``x_prev_ffn`` for the caller to write.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import linear_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Initializer, rms_norm

LORA_RANK = 32
MIX_KEYS = ("r", "k", "v", "g", "w")


def init_rwkv_block(init: Initializer, cfg: ModelConfig, g: int = 0):
    """One block's parameters (the reference's tree), with a leading group
    axis ``g`` when given.

    Scales: the reference's explicit 0.02, else ``1/sqrt(fan_in)``; the two
    projections that write the residual stream (``wo``, ``ffn_v``) are
    further scaled by ``1/sqrt(2 * n_layers)`` (GPT-2's rule).  The block
    runs on the un-normed residual and its FFN is quadratic in it, so at
    fan-in scale the residual grows without bound (NaN by the 7th of
    rwkv6-7b's 32 layers).
    """
    D = cfg.d_model
    dh = cfg.rwkv_head_dim
    H = D // dh
    out = (2 * cfg.n_layers) ** -0.5
    p = {
        "mu_base": init.normal((D,), scale=0.02, g=g),
        "wr": init.normal((D, D), g=g),
        "wk": init.normal((D, D), g=g),
        "wv": init.normal((D, D), g=g),
        "wg": init.normal((D, D), g=g),
        "wo": init.normal((D, D), scale=out * D ** -0.5, g=g),
        "u": init.normal((H, dh), scale=0.02, g=g),  # bonus
        "w_bias": init.normal((D,), scale=0.02, g=g),
        "ln_x": init.ones((D,), g=g, dtype="float32"),  # per-head group norm
        # channel mix (squared-ReLU FFN, receptance gated)
        "ffn_k": init.normal((D, cfg.d_ff), g=g),
        "ffn_v": init.normal((cfg.d_ff, D), scale=out * cfg.d_ff ** -0.5, g=g),
        "ffn_r": init.normal((D, D), g=g),
        "mu_ffn_k": init.normal((D,), scale=0.02, g=g),
        "mu_ffn_r": init.normal((D,), scale=0.02, g=g),
    }
    for z in MIX_KEYS:
        p[f"mu_{z}"] = init.normal((D,), scale=0.02, g=g)
        p[f"lora_a_{z}"] = init.normal((D, LORA_RANK), scale=0.02, g=g)
        p[f"lora_b_{z}"] = init.normal((LORA_RANK, D), scale=0.02, g=g)
    return p


class RWKVState(NamedTuple):
    x_prev_att: torch.Tensor  # (B, D) last token fed to time-mix
    x_prev_ffn: torch.Tensor  # (B, D)
    wkv: torch.Tensor  # (B, H, dh, dh) fp32 recurrent state


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype,
                    device) -> RWKVState:
    D = cfg.d_model
    dh = cfg.rwkv_head_dim
    return RWKVState(
        x_prev_att=torch.zeros((batch, D), dtype=dtype, device=device),
        x_prev_ffn=torch.zeros((batch, D), dtype=dtype, device=device),
        wkv=torch.zeros((batch, D // dh, dh, dh), dtype=torch.float32,
                        device=device),
    )


def _ddlerp(x, x_prev, p, z: str):
    """Data-dependent lerp between x and the shifted sequence (v6)."""
    xx = x_prev - x
    base = x + xx * p["mu_base"].to(x.dtype)
    lora = torch.tanh(base @ p[f"lora_a_{z}"].to(x.dtype)) \
        @ p[f"lora_b_{z}"].to(x.dtype)
    return x + xx * (p[f"mu_{z}"].to(x.dtype) + lora)


def _wkv_scan(r, k, v, w, u, state):
    """The WKV6 recurrence.  r,k,v,w: (B, T, H, dh); state: (B, H, dh, dh)
    float32, updated in place.  Returns ``(state, y)``, y float32.

    y_t = r_t · (S + u ⊙ k_t ⊗ v_t);  S' = diag(w_t)·S + k_t ⊗ v_t
    """
    return linear_scan.wkv6_scan(r, k, v, w, u, state, y_dtype=torch.float32)


def rwkv_block(x, p, cfg: ModelConfig, state: RWKVState = None):
    """x: (B, T, D).  Returns ``(out, new_state)``; ``state.wkv`` is updated
    in place and is ``new_state.wkv``."""
    B, T, D = x.shape
    dh = cfg.rwkv_head_dim
    H = D // dh

    if state is None:
        state = init_rwkv_state(cfg, B, x.dtype, x.device)

    # ---- time mix
    x_shift = torch.cat([state.x_prev_att[:, None, :], x[:, :-1, :]], dim=1)
    r = _ddlerp(x, x_shift, p, "r") @ p["wr"].to(x.dtype)
    k = _ddlerp(x, x_shift, p, "k") @ p["wk"].to(x.dtype)
    v = _ddlerp(x, x_shift, p, "v") @ p["wv"].to(x.dtype)
    g = F.silu(_ddlerp(x, x_shift, p, "g") @ p["wg"].to(x.dtype))
    w_lin = _ddlerp(x, x_shift, p, "w") + p["w_bias"].to(x.dtype)
    # clamp the log-log decay: exp(x) overflows f32 past ~88; [-8, 4] spans
    # decay in [~0, 0.9997]
    w_lin = torch.clamp(w_lin.float(), -8.0, 4.0)
    w = torch.exp(-torch.exp(w_lin))  # per-channel decay in (0,1)

    def hd(a):
        return a.reshape(B, T, H, dh)

    new_wkv, y = _wkv_scan(hd(r), hd(k), hd(v), hd(w), p["u"].float(),
                           state.wkv)
    y = y.reshape(B, T, D)
    y = rms_norm(y, p["ln_x"])  # group-norm stand-in over channels
    att_out = (y.to(x.dtype) * g) @ p["wo"].to(x.dtype)
    h = x + att_out

    # ---- channel mix
    h_shift = torch.cat([state.x_prev_ffn[:, None, :], h[:, :-1, :]], dim=1)
    xx = h_shift - h
    hk = h + xx * p["mu_ffn_k"].to(h.dtype)
    hr = h + xx * p["mu_ffn_r"].to(h.dtype)
    kk = torch.square(F.relu(hk @ p["ffn_k"].to(h.dtype)))
    ffn = torch.sigmoid(hr @ p["ffn_r"].to(h.dtype)) \
        * (kk @ p["ffn_v"].to(h.dtype))
    out = h + ffn

    new_state = RWKVState(x_prev_att=x[:, -1, :], x_prev_ffn=h[:, -1, :],
                          wkv=new_wkv)
    return out, new_state
