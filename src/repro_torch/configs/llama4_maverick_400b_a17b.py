"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 routed experts top-1 + shared expert on every SECOND
layer (alternating dense/MoE, matching the released interleave and the ~400B
total / 17B active budget).  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        rope_theta=500_000.0,
        n_experts=128, moe_top_k=1, moe_every=2, n_shared_experts=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke", family="moe",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        n_experts=8, moe_top_k=1, moe_every=2, n_shared_experts=1,
        q_block=16, kv_block=32,
    )
