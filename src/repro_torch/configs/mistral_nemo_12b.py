"""mistral-nemo-12b [dense]: 40L d=5120 32H (GQA kv=8) head_dim=128
d_ff=14336 vocab=131072 — 128k context (rope theta 1M).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=131072,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=512, q_block=16, kv_block=32,
    )
