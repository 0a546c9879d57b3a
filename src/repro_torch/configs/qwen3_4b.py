"""qwen3-4b [dense]: 36L d=2560 32H (GQA kv=8) head_dim=128 d_ff=9728
vocab=151936 — qk-norm on per-head q/k.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=9728, vocab_size=151936,
        rope_theta=1_000_000.0, qk_norm=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512, qk_norm=True, q_block=16, kv_block=32,
    )
