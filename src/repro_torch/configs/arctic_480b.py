"""arctic-480b [moe] — 128 experts top-2 + dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]"""

from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,  # dense residual branch
        vocab=32000,
        act="swiglu",
        moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                      dense_residual=True),
    )
