"""xlstm-1.3b [ssm]: 48 blocks d=2048, 4 heads, d_ff=0 (no separate FFN),
vocab=50304 — xLSTM[7:1]: superblocks of 7 mLSTM + 1 sLSTM.
[arXiv:2405.04517; unverified]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="xlstm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
        d_ff=0, vocab_size=50304,
        slstm_period=8, proj_factor=2.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="xlstm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=0, vocab_size=512,
        slstm_period=2, proj_factor=2.0, ssm_chunk=16,
        q_block=16, kv_block=32,
    )
