"""llava-next-34b [vlm]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
AnyRes vision tiling is a frontend STUB: input_specs supplies precomputed
patch embeddings (n_vis_tokens per image, prepended to the text sequence).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=20480, vocab_size=64000,
        rope_theta=5_000_000.0, n_vis_tokens=576,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, n_vis_tokens=8,
        q_block=16, kv_block=32,
    )
