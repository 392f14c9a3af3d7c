"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,           # shared block MLP
        vocab=32000,
        act="swiglu",
        block="mamba2",
        shared_attn_every=6,
        ssm_state=64,
    )
