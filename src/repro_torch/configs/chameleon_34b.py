"""chameleon-34b [vlm] — early-fusion: VQ image tokens share the 65536
vocab, so the backbone is a plain dense decoder (frontend = tokenizer stub).
[arXiv:2405.09818; unverified]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab=65536,
        act="swiglu",
        qk_norm=True,  # chameleon uses qk-norm for stability
    )
