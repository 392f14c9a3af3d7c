"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_ff=21504,
        vocab=262144,
        act="geglu",
        attn_pattern=("local", "local", "local", "local", "local", "global"),
        local_window=1024,
        rope_base=1_000_000.0,
        tie_embeddings=True,
    )
