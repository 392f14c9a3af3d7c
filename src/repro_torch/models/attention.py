"""Grouped-query attention with a chunked (flash-style) softmax.

Port of ``repro.models.attention``: GQA, qk-norm (qwen3), local
sliding-window / global mixes (gemma3), bidirectional and cross attention,
and the three modes of :func:`attention` (no cache, decode into a cache,
prefill into a cache).  :func:`chunked_attention` is the reference's
arithmetic; ``use_pallas=True`` swaps in the hand-written flash kernel
(:mod:`repro_torch.kernels.flash_attention`) exactly where the reference
swaps in its Pallas kernel: only with no cache and no ``cross_kv``.  Every
other call runs :func:`chunked_attention`, which is the reference's
semantics there, not a fallback.

Caches are updated in place (the reference returns new arrays): a prefill
or decode writes K/V into the cache tensors it is given and returns a
:class:`KVCache` over the same tensors with the advanced ``index``.  A
prefill that would run past the cache raises, where the reference's
``dynamic_update_slice`` clamps the write to the cache's end.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Initializer, apply_rope, rms_norm

NEG_INF = -2.0e38


def init_attention(init: Initializer, cfg: ModelConfig, g: int = 0,
                   n_heads=None, n_kv=None):
    H = n_heads or cfg.n_heads
    KV = n_kv or cfg.n_kv_heads
    D, dh = cfg.d_model, cfg.d_head
    p = {
        "wq": init.normal((D, H * dh), g=g),
        "wk": init.normal((D, KV * dh), g=g),
        "wv": init.normal((D, KV * dh), g=g),
        "wo": init.normal((H * dh, D), g=g),
    }
    if cfg.qk_norm:
        p["q_norm"] = init.ones((dh,), g=g, dtype="float32")
        p["k_norm"] = init.ones((dh,), g=g, dtype="float32")
    return p


class KVCache(NamedTuple):
    """Dense per-layer KV cache for decode.

    ``index`` is PER SEQUENCE (continuous batching: each slot has its own
    length).  Prefill (T > 1) requires all batch entries at equal index
    (the serving engine prefills one slot at a time); decode (T = 1)
    writes at per-slot positions.
    """

    k: torch.Tensor  # (B, S, KV, dh)
    v: torch.Tensor  # (B, S, KV, dh)
    index: torch.Tensor  # (B,) int32 — next write position (= current length)


def init_kv_cache(batch: int, max_seq: int, n_kv: int, d_head: int, dtype,
                  device) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, max_seq, n_kv, d_head), dtype=dtype, device=device),
        v=torch.zeros((batch, max_seq, n_kv, d_head), dtype=dtype, device=device),
        index=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _valid(kpos, q_pos, kv_lim, causal: bool, window: int):
    """(B|1, T|1, C) mask of the key positions ``kpos`` (C,)."""
    valid = kpos[None, None, :] < kv_lim
    if causal:
        valid = valid & (kpos[None, None, :] <= q_pos[:, :, None])
    if window > 0:
        valid = valid & (kpos[None, None, :] > q_pos[:, :, None] - window)
    return valid


def chunked_attention(q, k, v, q_pos, k_valid_len, causal: bool,
                      window: int = 0, chunk: int = 1024):
    """Online-softmax attention, scanning KV in chunks (flash algorithm).

    q: (B, T, H, dh); k/v: (B, S, KV, dh); q_pos: (B, T) absolute positions.
    k positions are arange(S); entries >= k_valid_len (scalar or per-batch
    (B,)) are masked out.  window > 0 => sliding-window (local) attention.
    Returns (B, T, H, dh) in q.dtype.  As in the reference, q is scaled in
    its own dtype and the logits and the p @ V products take their inputs
    in K/V's dtype with float32 sums.
    """
    B, T, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qg = (q * dh**-0.5).reshape(B, T, KV, G, dh)
    kv_lim = torch.as_tensor(k_valid_len, device=dev).reshape(-1)[:, None, None]

    if T == 1 or S <= chunk:
        logits = torch.einsum("btkgd,bskd->btkgs", qg.to(k.dtype).float(),
                              k.float())
        valid = _valid(torch.arange(S, device=dev), q_pos, kv_lim, causal, window)
        logits = logits.masked_fill(~valid[:, :, None, None, :], NEG_INF)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        out = torch.einsum("btkgs,bskd->btkgd", p.to(v.dtype).float(), v.float())
        out = out / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
        return out.reshape(B, T, H, dh).to(q.dtype)

    m = torch.full((B, T, KV, G), NEG_INF, device=dev)
    l = torch.zeros((B, T, KV, G), device=dev)
    acc = torch.zeros((B, T, KV, G, dh), device=dev)
    qk = qg.to(k.dtype).float()
    # K/V padded with zeros to a chunk multiple, as in the reference: the
    # padded keys are masked, but a row with no valid key averages them
    pad = -S % chunk
    k = F.pad(k, (0, 0, 0, 0, 0, pad))
    v = F.pad(v, (0, 0, 0, 0, 0, pad))
    for c0 in range(0, S + pad, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kpos = c0 + torch.arange(chunk, device=dev)
        logits = torch.einsum("btkgd,bckd->btkgc", qk, kb.float())
        valid = _valid(kpos, q_pos, kv_lim, causal, window)
        logits = logits.masked_fill(~valid[:, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "btkgc,bckd->btkgd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, T, H, dh).to(q.dtype)


def _write_decode(cache: KVCache, k, v) -> None:
    """Write each sequence's token at its own ``index``; an index at or past
    the cache's end writes nothing, as the reference's one-hot select."""
    S = cache.k.shape[1]
    rows = torch.arange(cache.k.shape[0], device=cache.k.device)
    pos = cache.index.clamp(max=S - 1).long()
    keep = (cache.index >= S)[:, None, None]
    for buf, new in ((cache.k, k), (cache.v, v)):
        buf[rows, pos] = torch.where(keep, buf[rows, pos], new[:, 0].to(buf.dtype))


def _write_prefill(cache: KVCache, k, v) -> None:
    """Contiguous write of T tokens at ``index[0]`` (all entries equal)."""
    T, S = k.shape[1], cache.k.shape[1]
    start = int(cache.index[0])
    if start + T > S:
        raise ValueError(f"prefill of {T} tokens at position {start} runs past "
                         f"the cache's {S} positions")
    cache.k[:, start:start + T] = k.to(cache.k.dtype)
    cache.v[:, start:start + T] = v.to(cache.v.dtype)


def attention(x, p, cfg: ModelConfig, kind: str = "global", positions=None,
              kv_cache: Optional[KVCache] = None, cross_kv=None,
              use_rope: bool = True, n_heads=None, n_kv=None,
              use_pallas: bool = False):
    """Full attention block (projections + attention + output proj).

    Modes:
      * train/prefill (kv_cache None): causal (kind: global/local) or
        bidirectional (kind="bidir").
      * cache given: x is (B, 1, D) for decode (append and attend) or
        (B, T, D) for a prefill written at the cache's index.
      * cross (cross_kv given): attend over precomputed encoder K/V.

    Returns ``(out, new_cache)``; ``new_cache`` shares the (updated) K/V
    tensors of ``kv_cache``.
    """
    H = n_heads or cfg.n_heads
    KV = n_kv or cfg.n_kv_heads
    dh = cfg.d_head
    B, T, _ = x.shape

    q = (x @ p["wq"].to(x.dtype)).reshape(B, T, H, dh)
    if cross_kv is None:
        k = (x @ p["wk"].to(x.dtype)).reshape(B, T, KV, dh)
        v = (x @ p["wv"].to(x.dtype)).reshape(B, T, KV, dh)
    else:
        k, v = cross_kv

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        if cross_kv is None:
            k = rms_norm(k, p["k_norm"])

    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=x.device).expand(B, T)
    if use_rope and cross_kv is None:
        q = apply_rope(q, positions, cfg.rope_base)
        k = apply_rope(k, positions, cfg.rope_base)

    new_cache = None
    if kv_cache is not None and cross_kv is None:
        if T == 1:
            _write_decode(kv_cache, k, v)
        else:
            _write_prefill(kv_cache, k, v)
        new_cache = KVCache(kv_cache.k, kv_cache.v, kv_cache.index + T)
        k, v = kv_cache.k, kv_cache.v
        k_valid = new_cache.index
    else:
        k_valid = torch.full((B,), k.shape[1], dtype=torch.int32,
                             device=x.device)
    S = k.shape[1]

    causal = kind in ("global", "local") and cross_kv is None
    window = cfg.local_window if kind == "local" else 0

    if use_pallas and kv_cache is None and cross_kv is None:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        chunk = min(1024, max(128, S)) if S >= 128 else S
        out = chunked_attention(q, k, v, positions, k_valid, causal=causal,
                                window=window, chunk=chunk)

    out = out.reshape(B, T, H * dh) @ p["wo"].to(x.dtype)
    return out, new_cache
