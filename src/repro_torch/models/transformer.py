"""Decoder-LM assembly for the dense attention and rwkv6 families.

Port of ``repro.models.transformer`` for ``block == "attn"`` without MoE
(global and local/global attention patterns, qk-norm, tied embeddings,
logit soft-capping, ``unembed_last_only``) and for ``block == "rwkv6"``.
The reference's stage plan is kept: a stage is ``(group_count, block
pattern)`` and its parameters and caches carry a leading group axis.
Where the reference scans a stage with ``lax.scan``, the port loops over
the groups and slices each layer's tensors out of the stacked ones.

  qwen3/internlm2/nemotron/chameleon : [(L, (attn-global,))]
  gemma3 (5 local : 1 global, 62L)   : [(10, (l,l,l,l,l,g)), (1, (l,l))]
  rwkv6                              : [(L, (rwkv6,))]

As in the reference, an rwkv6 block carries ``ln1`` and ``ln2`` but runs on
the un-normed residual, and ignores positions and ``cache_len``.  The MoE,
mamba2 and encoder-decoder families raise ``NotImplementedError``
(ROADMAP queue 1 item 13).

Parameters are nested dictionaries of tensors in the reference's tree
layout (``convert.transformer_params_from_numpy`` maps the JAX tree).
:func:`init_params` draws them from a ``torch.Generator``: the reference
draws from ``jax.random``, so the two never share weights by seed.  Caches
are updated in place: K/V by :mod:`repro_torch.models.attention`, every
leaf of a recurrent state (:class:`~repro_torch.models.rwkv.RWKVState`) by
:func:`forward`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.attention import (KVCache, attention, init_attention,
                                          init_kv_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Initializer, rms_norm, torch_dtype
from repro_torch.models.rwkv import init_rwkv_block, init_rwkv_state, rwkv_block


@dataclasses.dataclass(frozen=True)
class BlockDesc:
    kind: str  # "attn" | "rwkv6" | "mamba2"
    attn_kind: str = "global"  # for attn blocks: global | local
    shared_attn: bool = False  # zamba2: run the shared attn block first


def build_stages(cfg: ModelConfig):
    """Returns [(group_count, tuple[BlockDesc, ...]), ...]."""
    if cfg.block == "attn":
        pattern = tuple(BlockDesc("attn", k) for k in cfg.attn_pattern)
    elif cfg.block == "rwkv6":
        pattern = (BlockDesc("rwkv6"),)
    elif cfg.block == "mamba2":
        k = cfg.shared_attn_every
        if k:
            pattern = (BlockDesc("mamba2", shared_attn=True),) + tuple(
                BlockDesc("mamba2") for _ in range(k - 1))
        else:
            pattern = (BlockDesc("mamba2"),)
    else:
        raise ValueError(cfg.block)

    P = len(pattern)
    stages = []
    if cfg.n_layers // P:
        stages.append((cfg.n_layers // P, pattern))
    if cfg.n_layers % P:
        stages.append((1, pattern[: cfg.n_layers % P]))
    return stages


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families this port does not run yet."""
    if cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            "(ROADMAP queue 1 item 13)")
    if cfg.block not in ("attn", "rwkv6"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.block} blocks are not ported yet (ROADMAP "
            "queue 1 item 13)")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP queue 1 "
            "item 13)")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _init_block(init: Initializer, cfg: ModelConfig, desc: BlockDesc, g: int):
    if desc.kind == "rwkv6":
        return {
            "ln1": L.init_rms_norm(init, cfg.d_model, g=g),
            "rwkv": init_rwkv_block(init, cfg, g=g),
            "ln2": L.init_rms_norm(init, cfg.d_model, g=g),
        }
    return {
        "ln1": L.init_rms_norm(init, cfg.d_model, g=g),
        "attn": init_attention(init, cfg, g=g),
        "ln2": L.init_rms_norm(init, cfg.d_model, g=g),
        "mlp": L.init_mlp(init, cfg.d_model, cfg.d_ff, cfg.act, g=g),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device: str = "cuda"):
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    in ``cfg.param_dtype``, on ``device``."""
    check_supported(cfg)
    init = Initializer(seed, cfg.param_dtype, resolve_device(device))
    params: dict = {
        "embed": L.init_embedding(init, cfg.vocab, cfg.d_model),
        "final_norm": L.init_rms_norm(init, cfg.d_model),
        "stages": [],
    }
    for g, pattern in build_stages(cfg):
        params["stages"].append(
            tuple(_init_block(init, cfg, desc, g) for desc in pattern))
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_embedding(init, cfg.vocab, cfg.d_model)
    return params


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device: str = "cuda"):
    """Cache structure mirroring the stages: per stage a tuple (one per
    pattern position) of :class:`KVCache` (attention) or
    :class:`~repro_torch.models.rwkv.RWKVState` (rwkv6), every leaf with a
    leading group axis."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.compute_dtype)
    caches = []
    for g, pattern in build_stages(cfg):
        stage = []
        for desc in pattern:
            if desc.kind == "rwkv6":
                c = init_rwkv_state(cfg, g * batch, dtype, dev)
            else:
                c = init_kv_cache(g * batch, max_seq, cfg.n_kv_heads,
                                  cfg.d_head, dtype, dev)
            stage.append(type(c)(*(t.reshape(g, batch, *t.shape[1:])
                                   for t in c)))
        caches.append(tuple(stage))
    return caches


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter dictionary (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_block(h, bp, desc: BlockDesc, cfg: ModelConfig, positions, cache,
                 use_pallas: bool):
    """One block.  Returns ``(h, new_cache)``."""
    if desc.kind == "rwkv6":  # on the un-normed residual, as the reference
        return rwkv_block(h, bp["rwkv"], cfg, cache)
    a, new_c = attention(rms_norm(h, bp["ln1"]["scale"]), bp["attn"], cfg,
                         desc.attn_kind, positions, kv_cache=cache,
                         use_pallas=use_pallas)
    h = h + a
    h = h + L.mlp(rms_norm(h, bp["ln2"]["scale"]), bp["mlp"], cfg.act)
    return h, new_c


def forward(params, tokens, cfg: ModelConfig, caches=None, cache_len=None,
            use_pallas: bool = False, unembed_last_only: bool = False,
            device: str = "cuda"):
    """tokens: (B, T) int (a tensor or anything ``torch.as_tensor`` takes).

    caches None  -> train/prefill without cache retention.
    caches given -> positions offset by cache_len; the caches are updated
                    in place (prefill writes T entries, decode writes 1;
                    a recurrent state is overwritten by the new one, and
                    ignores cache_len).

    ``use_pallas=True`` runs the flash-attention kernel in every layer of a
    forward without caches (the reference's Pallas switch); with caches
    it changes nothing.  The parameters must lie on ``device``.

    Returns ``(logits_f32, new_caches, aux)``; ``aux`` holds the
    reference's MoE statistics, zero for these families.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    table_in = params["embed"]["table"]
    if table_in.device.type != dev.type:
        raise ValueError(f"parameters on {table_in.device}, forward asked to "
                         f"run on {dev}")
    tokens = torch.as_tensor(tokens, device=table_in.device)
    compute = torch_dtype(cfg.compute_dtype)
    h = L.embed(tokens, table_in, compute)
    B, T = tokens.shape

    base = torch.zeros((), dtype=torch.int32, device=h.device) \
        if cache_len is None else torch.as_tensor(cache_len, device=h.device)
    base = base.to(torch.int32).reshape(-1).expand(B)
    positions = base[:, None] + torch.arange(T, dtype=torch.int32,
                                             device=h.device)[None, :]

    new_caches = [] if caches is not None else None
    for si, (g, pattern) in enumerate(build_stages(cfg)):
        stage_params = params["stages"][si]
        stage_cache = caches[si] if caches is not None else None
        new_index = [[] for _ in pattern]
        for li in range(g):
            for pi, desc in enumerate(pattern):
                c = None
                if stage_cache is not None:
                    sc = stage_cache[pi]
                    c = type(sc)(*(leaf[li] for leaf in sc))
                h, nc = _apply_block(h, _layer(stage_params[pi], li), desc,
                                     cfg, positions, c, use_pallas)
                if isinstance(nc, KVCache):
                    new_index[pi].append(nc.index)
                elif c is not None:  # a recurrent state: into the cache
                    for dst, src in zip(c, nc):
                        if src is not dst:
                            dst.copy_(src)
        if caches is not None:
            new_caches.append(tuple(
                KVCache(sc.k, sc.v, torch.stack(idx))
                if isinstance(sc, KVCache) else sc
                for sc, idx in zip(stage_cache, new_index)))

    h = rms_norm(h, params["final_norm"]["scale"])
    if unembed_last_only:
        h = h[:, -1:]
    table = (params["embed"] if cfg.tie_embeddings else params["unembed"])["table"]
    logits = L.unembed(h, table)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    zero = torch.zeros((), device=h.device)
    return logits, new_caches, {"moe_aux_loss": zero, "moe_drop_frac": zero}


def decode_step(params, tokens, caches, cache_len, cfg: ModelConfig,
                use_pallas: bool = False, device: str = "cuda"):
    """One decode step.  tokens: (B, 1).  Returns (logits, new_caches)."""
    logits, new_caches, _ = forward(params, tokens, cfg, caches=caches,
                                    cache_len=cache_len, use_pallas=use_pallas,
                                    device=device)
    return logits, new_caches
