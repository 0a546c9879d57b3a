"""minicpm-2b [dense]: 40L d=2304 36H (MHA kv=36) d_ff=5760 vocab=122753.
Llama-like arch with mup-style scaling (scale_emb=12, scale_depth=1.4) and
the WSD learning-rate schedule (optim/schedules.py).  [arXiv:2404.06395; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
        d_ff=5760, vocab_size=122753,
        rope_theta=10_000.0, scale_emb=12.0, scale_depth=1.4,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=511, scale_emb=12.0, scale_depth=1.4,
        tie_embeddings=True, q_block=16, kv_block=32,
    )
