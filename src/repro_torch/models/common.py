"""Model configuration and parameter-init helpers.

Counterpart of ``repro/models/common.py``: ``ModelConfig`` has the
reference's fields and properties, with torch dtypes; the init helpers draw
from an explicit ``torch.Generator``, so a model's weights follow from its
seed (they are not the JAX package's numbers: the two generators differ).
``NullPolicy`` is the reference's no-op activation hook
(``distributed/shardings.py`` provides the real one); the port draws from
explicit generators and stacks through ``stack_leaves``, so it has no
``KeyGen`` or ``stack_layer_params``.

Two storage modes share the module classes.  Serving stores each leaf as
the reference's ``cast_params`` leaves it (the compute dtype where it
casts, the parameter dtype elsewhere), frozen.  Training (a module built
under ``train_storage()``) stores every leaf in the parameter dtype (fp32
masters) with ``requires_grad``; ``stack_leaves`` then gives each leaf of
the reference's stacked tree one tensor, of which the per-layer parameters
are views, with a gradient buffer laid out the same way, and
``cast_params`` gives the compute-dtype view a training forward reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
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

_STORAGE = threading.local()


@contextlib.contextmanager
def train_storage():
    """Modules built inside store fp32 masters that require grad."""
    prev = getattr(_STORAGE, "train", False)
    _STORAGE.train = True
    try:
        yield
    finally:
        _STORAGE.train = prev


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
    ``cast=True``.  Under ``train_storage()`` every leaf is an fp32 master
    that requires grad, and ``cast_params`` casts the ones marked cast."""
    if cast is None:
        cast = len(shape) >= 2
    train = getattr(_STORAGE, "train", False)
    dt = cfg.compute_dtype if cast and not train else cfg.param_dtype
    p = nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                     requires_grad=train)
    p.ref_cast = cast               # the reference's cast_params casts it
    return p


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


def param_count(params) -> int:
    """Values in a module's parameters or a tree of arrays."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return int(math.prod(params.shape))


# ---------------------------------------------------------------------------
# the reference's stacked tree over a module's per-layer parameters
# ---------------------------------------------------------------------------

def _owners(module: nn.Module, path=(), idx=()):
    """(tree path, stack index, owning module, attribute) for every
    parameter of ``module``, its ModuleLists read as stacks: a dict key is
    an attribute, and the i-th module of a ModuleList takes index i of the
    stack's next axis."""
    if isinstance(module, nn.ModuleList):
        for i, m in enumerate(module):
            yield from _owners(m, path, idx + (i,))
        return
    for name, _ in module.named_parameters(recurse=False):
        yield path + (name,), idx, module, name
    for name, m in module.named_children():
        yield from _owners(m, path + (name,), idx)


def by_path(module: nn.Module) -> dict:
    """Tree path -> [(stack index, parameter)] in stack order."""
    out: dict = {}
    for path, idx, owner, name in _owners(module):
        out.setdefault(path, []).append((idx, getattr(owner, name)))
    return out


@dataclass
class Leaf:
    """One leaf of the reference's tree: ``value`` (stack axes first; the
    per-layer parameters are views of it) and ``grad``, laid out the same
    way, into which backward accumulates."""
    path: tuple
    value: torch.Tensor
    grad: torch.Tensor


def stack_leaves(module: nn.Module) -> nn.Module:
    """Rebind a training module's parameters as views of one tensor per
    reference leaf, each with a gradient view of one zeroed buffer per
    leaf (backward adds into a defined ``.grad`` in place), and keep the
    leaves, in the reference's order (keys sorted at every level), as
    ``module.ref_leaves``.  Returns ``module``."""
    groups: dict = {}
    for path, idx, owner, name in _owners(module):
        groups.setdefault(path, []).append((idx, owner, name))
    leaves = {}
    for path, items in groups.items():
        first = getattr(items[0][1], items[0][2])
        stack = tuple(max(i[k] for i, _, _ in items) + 1
                      for k in range(len(items[0][0])))
        value = torch.empty(stack + tuple(first.shape), dtype=first.dtype,
                            device=first.device)
        grad = torch.zeros_like(value)
        for idx, owner, name in items:
            old = getattr(owner, name)
            with torch.no_grad():
                value[idx].copy_(old)
            p = nn.Parameter(value[idx], requires_grad=old.requires_grad)
            p.ref_cast = old.ref_cast
            p.grad = grad[idx]
            setattr(owner, name, p)
        leaves[path] = Leaf(path, value, grad)
    module.ref_leaves = [leaves[p] for p in sorted(leaves)]
    return module


def leaf_tree(module: nn.Module, what: str = "value") -> dict:
    """The reference's dict tree of ``module.ref_leaves``' values (or
    gradients)."""
    tree: dict = {}
    for leaf in module.ref_leaves:
        node = tree
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = getattr(leaf, what)
    return tree


# leaves read through a lookup: with cast_params_once=False the reference
# takes their fp32 rows and casts those
_LOOKUP_LEAVES = ("embed",)


class CastView:
    """A module's parameters as a training forward reads them: the same
    attributes (ModuleLists as lists, children as views), each parameter
    the reference's ``cast_params`` casts as a differentiable ``.to`` of
    the compute dtype, the others as they are, each made on first access
    and kept; the module's methods run on the view.  With ``once`` False
    (``cast_params_once=False``) only the matrices the reference casts
    where it uses them: a layer's 1-D leaves and the embeddings stay fp32,
    and the code that reads them casts them (or their rows) itself, as the
    reference's does."""

    def __init__(self, module: nn.Module, dtype: torch.dtype,
                 once: bool = True):
        self._module = module
        self._dtype = dtype
        self._once = once

    def __getattr__(self, name):
        m = self._module
        if name in m._parameters:
            p = m._parameters[name]
            cast = (p.ref_cast and p.dtype == torch.float32
                    and (self._once or (p.dim() >= 2
                                        and name not in _LOOKUP_LEAVES)))
            val = p.to(self._dtype) if cast else p
        elif name in m._modules:
            val = _view(m._modules[name], self._dtype, self._once)
        else:
            attr = getattr(type(m), name)
            return attr.__get__(self) if callable(attr) else attr
        setattr(self, name, val)
        return val


def _view(m: nn.Module, dtype: torch.dtype, once: bool):
    if isinstance(m, nn.ModuleList):
        return [_view(x, dtype, once) for x in m]
    return CastView(m, dtype, once)


def cast_params(params: nn.Module, cfg: ModelConfig):
    """The compute-dtype view of a training module (the reference's
    ``cast_params``: leaves of two or more dimensions in its stacked tree,
    fp32 ones, to the compute dtype).  A serving module is returned as it
    is: it stores those leaves cast already.  With ``cast_params_once=False``
    the reference keeps the fp32 leaves and casts each where it is used:
    the view casts the matrices, which gives the same values, and leaves
    the rest fp32 (``CastView``); in a sharded step the knob also decides
    whether the gather moves the cast or the fp32 masters
    (``distributed/shardings.py``)."""
    if getattr(params, "ref_leaves", None) is None:     # serving storage
        return params
    return CastView(params, cfg.compute_dtype, cfg.cast_params_once)


# ---------------------------------------------------------------------------
# sharding policy hook (distributed/shardings.py provides the real one)
# ---------------------------------------------------------------------------

class NullPolicy:
    """No-op activation-sharding policy (single-device paths, smoke
    tests)."""

    def act(self, x, kind: str):
        return x


NULL_POLICY = NullPolicy()
