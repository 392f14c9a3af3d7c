"""qwen3-32b [dense] — GQA + qk-norm.  [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        d_ff=25600,
        vocab=151936,
        act="swiglu",
        qk_norm=True,
        rope_base=1_000_000.0,
    )
