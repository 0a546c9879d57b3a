"""Model configuration and parameter-init helpers.

Counterpart of ``repro/models/common.py``: ``ModelConfig`` has the
reference's fields and properties, with torch dtypes; the init helpers draw
from an explicit ``torch.Generator``, so a model's weights follow from its
seed (they are not the JAX package's numbers: the two generators differ).
The sharding policy hooks are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str             # dense | moe | hybrid_ssm | xlstm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # attention
    rope_theta: float = 1_000_000.0
    rotary_pct: float = 1.0        # chatglm3: 0.5 ("RoPE 2d")
    qk_norm: bool = False          # qwen3
    attn_logit_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    moe_top_k: int = 1
    moe_every: int = 1
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # hybrid SSM (zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0
    # xLSTM
    slstm_period: int = 0
    proj_factor: float = 2.0
    # audio (musicgen)
    n_codebooks: int = 0
    # vlm (llava-next)
    n_vis_tokens: int = 0
    # scaling tricks
    scale_emb: float = 1.0         # minicpm: 12.0
    scale_depth: float = 0.0       # minicpm: 1.4 (residual x this/sqrt(L))
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # the reference's attention blocking and perf knobs; the port's
    # attention kernel has its own tiles, so only attn_scores_bf16 (which
    # changes the numbers) is refused by the model
    q_block: int = 512
    kv_block: int = 1024
    ssm_chunk: int = 256
    attn_scores_bf16: bool = False
    causal_skip: bool = False
    cast_params_once: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/head storage rows: the published vocab padded to a
        multiple of 256 when it is not a multiple of 16 (minicpm's
        122753); padded logit columns are sliced off the head."""
        if self.vocab_size % 16 == 0:
            return self.vocab_size
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_groups(self) -> int:
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")
        return self.n_heads // self.n_kv_heads

    @property
    def residual_scale(self) -> float:
        return (self.scale_depth / math.sqrt(self.n_layers)
                if self.scale_depth else 1.0)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _param(shape, cfg: ModelConfig, device, cast: bool | None = None
           ) -> nn.Parameter:
    """An uninitialised parameter in the compute dtype when ``cast`` (by
    default: at two or more dimensions, the reference's ``cast_params``
    on a leaf outside a layer stack), else in the parameter dtype.  A 1-D
    leaf of a layer stack has two dimensions in the reference's tree, so
    its cast rounds it to the compute dtype.  Norm weights enter only
    through ``rmsnorm``, which casts them, and stay in the parameter
    dtype; the other 1-D leaves of the Mamba2 and xLSTM stacks (biases,
    ``A_log``, ``D``), some of which enter fp32 arithmetic, pass
    ``cast=True``."""
    if cast is None:
        cast = len(shape) >= 2
    dt = cfg.compute_dtype if cast else cfg.param_dtype
    return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                        requires_grad=False)


def dense_init(shape, generator: torch.Generator, dtype=torch.float32,
               scale: float | None = None, device=None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init (fan-in = shape[-2] unless
    ``scale`` gives σ), drawn on ``device`` from ``generator``: the inverse
    CDF of a uniform draw, as ``torch.nn.init.trunc_normal_`` computes it."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    lo = math.erf(-2.0 / math.sqrt(2.0))          # CDF(-2) mapped to [-1, 1]
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(lo, -lo, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0) * std).clamp_(-2.0 * std, 2.0 * std)
    return t.to(dtype)


def embed_init(shape, generator: torch.Generator, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """N(0, 0.02²)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(0.0, 0.02, generator=generator)
    return t.to(dtype)
