"""musicgen-medium [audio]: 48L d=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.
Decoder-only LM over EnCodec tokens: 4 codebooks summed at the input, 4
output heads (the EnCodec encoder/decoder is the frontend stub — tokens are
the model inputs).  [arXiv:2306.05284; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab_size=2048,
        rope_theta=10_000.0, n_codebooks=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128, n_codebooks=4, q_block=16, kv_block=32,
    )
