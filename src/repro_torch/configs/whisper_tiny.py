"""whisper-tiny [audio] — enc-dec backbone; conv/log-mel frontend is a STUB
(input_specs provides precomputed frame embeddings).  Tiny model: runs
data-parallel only (no TP).  [arXiv:2212.04356; unverified]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,          # decoder layers
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab=51865,
        act="gelu",
        encdec=True,
        enc_layers=4,
        enc_positions=1500,
        tie_embeddings=True,
        tensor_parallel=False,
        max_seq=32768,
    )
