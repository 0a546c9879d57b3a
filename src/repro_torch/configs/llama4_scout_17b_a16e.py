"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 routed experts top-1 + 1 shared expert on every layer
(early-fusion multimodal frontend stubbed out — text backbone only).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        rope_theta=500_000.0,
        n_experts=16, moe_top_k=1, moe_every=1, n_shared_experts=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        n_experts=4, moe_top_k=1, moe_every=1, n_shared_experts=1,
        q_block=16, kv_block=32,
    )
