"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,          # = d_model / rwkv_head_dim, bookkeeping only
        n_kv_heads=64,
        d_ff=14336,
        vocab=65536,
        act="sqrelu",        # rwkv channel-mix uses squared ReLU
        block="rwkv6",
        rwkv_head_dim=64,
    )
