"""zamba2-1.2b [hybrid]: 38 Mamba2 layers (d_state=64) + ONE shared
attention+MLP block (32H MHA, d_ff=8192) applied every 6 layers, d=2048,
vocab=32000.  [arXiv:2411.15242; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid_ssm",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=32000,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
        attn_every=6, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid_ssm",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4,
        attn_every=2, tie_embeddings=True, ssm_chunk=16,
        q_block=16, kv_block=32,
    )
