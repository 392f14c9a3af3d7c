"""llama4-scout-17b-a16e [moe] — 16 experts top-1, early fusion (text
backbone; the fused-modality tokens live in the 202k vocab).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab=202048,
        act="swiglu",
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192),
    )
