"""Model configuration for the assigned architecture pool.

A copy of ``src/repro/models/config.py`` (no jax in it), kept in the port so
that ``repro_torch`` imports nothing of ``repro``.  Change both together.

One frozen dataclass covers all ten families; the block pattern / stage
machinery in transformer.py interprets it.  Full-size configs are only ever
lowered abstractly (dry-run); smoke tests use reduced() variants.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    d_head: int = 0  # 0 -> d_model // n_heads
    act: str = "swiglu"  # swiglu | sqrelu | gelu
    qk_norm: bool = False
    # attention pattern, cycled over layers: e.g. 5 local + 1 global (gemma3)
    attn_pattern: Tuple[str, ...] = ("global",)
    local_window: int = 1024
    rope_base: float = 10_000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    moe: Optional[MoEConfig] = None

    # block type: attn | rwkv6 | mamba2 (hybrid uses mamba2 + shared attn)
    block: str = "attn"
    shared_attn_every: int = 0  # zamba2: run the shared attn block every k
    ssm_state: int = 64
    ssm_conv_width: int = 4
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper backbone); frontend is a stub that yields
    # precomputed frame embeddings of length enc_positions.
    encdec: bool = False
    enc_layers: int = 0
    enc_positions: int = 1500

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # tiny models (whisper) skip tensor parallelism: all params replicated
    tensor_parallel: bool = True

    # ---- perf knobs (EXPERIMENTS.md §Perf; all default to the paper-
    # faithful / naive baseline) ----
    # shard the residual stream's sequence dim over "model" between blocks
    # (sequence parallelism: converts TP all-reduces into RS+AG)
    sequence_parallel: bool = False
    # split the Mamba2 in_proj so B/C/dt are replicated (kills the
    # per-timestep all-gathers of cross-sharded small tensors in the scan)
    ssm_split_proj: bool = False
    # 2D expert sharding: experts over "data", expert-FFN hidden over
    # "model" (vs experts over "model" only) — 16x less expert HBM/chip
    moe_ep2d: bool = False

    # sequence limit used by serving caches (not a hard model limit)
    max_seq: int = 524_288

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.block == "attn" and self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")

    # ------------------------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.block == "rwkv6" or (self.block == "mamba2" and self.shared_attn_every == 0)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token contexts without full global KV?"""
        if self.block in ("rwkv6", "mamba2"):
            return True
        # local:global mixes are window-bounded on most layers
        return "local" in self.attn_pattern

    def layer_kinds(self):
        """Per-layer attention kind, cycling attn_pattern."""
        pat = self.attn_pattern
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, KV, dh = self.n_heads, self.n_kv_heads, self.d_head
        per_layer = 0
        if self.block == "attn":
            per_layer += D * (H * dh) + 2 * D * (KV * dh) + (H * dh) * D
            if self.qk_norm:
                per_layer += 2 * dh
        elif self.block == "rwkv6":
            # r,k,v,g,w projections + out + ddlerp loras (rank 32) + u
            per_layer += 6 * D * D + 5 * (2 * 32 * D) + 2 * D
        elif self.block == "mamba2":
            d_inner = 2 * D  # expansion 2 (repro.models.ssm.EXPAND)
            n_h = max(1, d_inner // 64)
            per_layer += D * (2 * d_inner + 2 * self.ssm_state + n_h)  # in_proj
            per_layer += self.ssm_conv_width * (d_inner + 2 * self.ssm_state)
            per_layer += d_inner * D  # out_proj
            per_layer += 3 * n_h + d_inner  # A, D, dt bias, norm
        if self.moe is not None:
            e = self.moe
            per_layer += D * e.n_experts  # router
            mult = 3 if self.act in ("swiglu", "geglu") else 2
            per_layer += e.n_experts * mult * D * e.d_ff_expert
            if e.dense_residual:
                per_layer += mult * D * F
        elif self.block != "mamba2":  # mamba2 blocks have no separate FFN
            mult = 3 if self.act in ("swiglu", "geglu") else 2
            per_layer += mult * D * F
        per_layer += 2 * D  # norms
        total = self.n_layers * per_layer
        if self.shared_attn_every:
            total += D * (H * dh) + 2 * D * (KV * dh) + (H * dh) * D  # shared attn
            total += (3 if self.act in ("swiglu", "geglu") else 2) * D * F + 2 * D
        total += V * D  # embedding
        if not self.tie_embeddings:
            total += V * D
        total += D  # final norm
        if self.encdec:
            el = self.enc_layers
            enc_per = 4 * D * D + (2 if self.act == "gelu" else 3) * D * F + 2 * D
            dec_cross = 4 * D * D + D  # cross-attn per decoder layer
            total += el * enc_per + self.n_layers * dec_cross
        return int(total)

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE counts top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        inactive = (e.n_experts - e.top_k) * mult * self.d_model * e.d_ff_expert
        return int(self.param_count() - self.n_layers * inactive)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=max(2, len(self.attn_pattern)) if len(self.attn_pattern) > 1 else 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.block == "attn" else 4,
            d_ff=128,
            vocab=256,
            d_head=16,
            local_window=16,
            param_dtype="float32",
            compute_dtype="float32",
            rwkv_head_dim=16,
            ssm_state=8,
            enc_layers=2 if self.encdec else 0,
            enc_positions=24 if self.encdec else 1500,
            shared_attn_every=2 if self.shared_attn_every else 0,
            max_seq=512,
        )
        if self.moe is not None:
            small["moe"] = MoEConfig(
                n_experts=4, top_k=self.moe.top_k, d_ff_expert=128,
                dense_residual=self.moe.dense_residual,
                # no-drop capacity in smoke tests so cache-path consistency
                # checks are exact (capacity dropping is batch-order dependent)
                capacity_factor=4.0,
            )
        if self.block == "mamba2":
            small["n_kv_heads"] = 4
        small.update(overrides)
        return dataclasses.replace(self, name=self.name + "-reduced", **small)
