"""chatglm3-6b [dense]: 28L d=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"RoPE 2d": rotary applied to half the head dims (rotary_pct=0.5).
[arXiv:2406.12793; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
        d_ff=13696, vocab_size=65024,
        rope_theta=10_000.0, rotary_pct=0.5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512, rotary_pct=0.5, q_block=16, kv_block=32,
    )
