"""Sharding rules and the sharded train state over a grid of ranks.

Counterpart of ``repro/distributed/shardings.py``.  The rule tables are the
reference's, with a spec written as a plain tuple of axis names per
dimension (``None``, ``"data"``, ``"model"``, or a tuple of axes, as
``("pod", "data")`` for data parallelism over two axes): ``param_spec`` and
``tree_specs`` by tree path (the optimizer state's ``m``/``v``/``f`` and
``vr``/``vc`` paths included), ``act_spec`` by activation kind,
``batch_specs`` and ``cache_specs``.

The reference hands the specs to GSPMD.  The port's ranks are processes of
a ``distributed.mesh.RankGrid`` that run eagerly, and a policy runs the
same placement by hand (ZeRO semantics):

* each rank stores only its block of every fp32 master and of the
  optimizer state, the leaf split by its spec over the grid (a dimension
  of ``n`` over ``k`` ranks in blocks of ``ceil(n / k)``, the last ones
  short or empty, as GSPMD pads an uneven split);
* a step gathers every leaf whole into the training module (the masters'
  compute-dtype cast on the wire with ``cast_params_once``, the fp32
  masters gathered and then cast without it: the same values), runs
  forward and backward on this rank's ``batch_specs`` block of the batch,
  reduce-scatters each gradient to its leaf's owners (a mean over the
  data-parallel ranks), takes the global gradient norm with one all-reduce
  (a leaf held by several ranks counted once), and applies the optimizer
  to the local blocks (Adafactor's means over a split dimension are
  all-reduced, ``PolicyLayout``).

Compute along ``"model"`` is replicated: every rank of a data block
computes on whole leaves, so ``act`` returns ``x`` (in the reference it is
a layout constraint that changes no number).  Checkpoints hold the
canonical, unsharded tree (``state_tree``), restored into any grid
(``load_state_tree``).
"""
from __future__ import annotations

import math
import re
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.optim.optimizers import _leaves


# ---------------------------------------------------------------------------
# parameter rules: (regex on path, spec for the trailing dims by rank)
# ---------------------------------------------------------------------------

def _param_rules(fsdp: Optional[str]):
    d = fsdp           # 'data' or None
    return [
        # embeddings / heads
        (r"embed$",            {3: (None, "model", d), 2: ("model", d)}),
        (r"out_head$",         {3: (None, d, "model"), 2: (d, "model")}),
        # attention
        (r"attn\d*/(wq|wk|wv)$", {2: (d, "model")}),
        (r"shared_attn/(wq|wk|wv)$", {2: (d, "model")}),
        (r"wo$",               {2: ("model", d)}),
        # dense mlp
        (r"(w_gate|w_up|shared_gate|shared_up|up_x|up_z)$",
         {2: (d, "model")}),
        (r"(w_down|shared_down|down)$", {2: ("model", d)}),
        # moe experts: E on 'model'
        (r"moe\d*/w_gate$",    {3: ("model", d, None)}),
        (r"moe\d*/w_up$",      {3: ("model", d, None)}),
        (r"moe\d*/w_down$",    {3: ("model", None, d)}),
        (r"router$",           {2: (None, None)}),
        # mamba2
        (r"in_proj$",          {2: (d, "model")}),
        (r"out_proj$",         {2: ("model", d)}),
        (r"conv_w$",           {2: (None, "model")}),
        (r"conv_b$",           {1: ("model",)}),
        # xlstm
        (r"w_[qkv]$",          {2: (None, "model")}),
        (r"w_gates$",          {2: (None, None)}),
        (r"/r$",               {3: (None, None, "model")}),
        (r"w_x$",              {2: (d, "model")}),
        (r"/out$",             {2: ("model", d)}),
    ]


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists (the
    reference's ``tree_map_with_path`` over the same structure)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _dim_axes(entry) -> tuple:
    """One spec entry as a tuple of axes (outermost first)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class ShardingPolicy:
    """The reference's rules, and the sharded state and step they place
    on ``mesh`` (a ``RankGrid``; any object with ``axis_names`` serves the
    rule tables alone)."""

    def __init__(self, mesh, fsdp: bool = True, seq_parallel: bool = False):
        self.mesh = mesh
        self.fsdp = fsdp
        # shard the residual stream's seq dim over 'model' (Megatron-SP)
        self.seq_parallel = seq_parallel
        self.dp = (("pod", "data") if "pod" in mesh.axis_names
                   else "data")
        self._rules = _param_rules("data" if fsdp else None)

    # -- parameters -------------------------------------------------------
    def param_spec(self, path: str, ndim: int) -> tuple:
        for pat, by_rank in self._rules:
            if re.search(pat, path):
                for rank in sorted(by_rank, reverse=True):
                    if ndim >= rank:
                        spec = by_rank[rank]
                        return (None,) * (ndim - len(spec)) + spec
        return ()      # replicate (norm weights, biases, scalars)

    def tree_specs(self, tree) -> Any:
        """Spec tree for a parameter- or ``state_tree``-shaped tree.
        Optimizer-state wrappers (m/v/f, vr/vc) reuse the parameter rule on
        the cleaned path, with factored dims dropped."""
        def one(path, leaf):
            p = _path_str(path)
            clean = re.sub(r"^(0/)?(params|opt|m|v|f)/", "", p)
            clean = re.sub(r"^(m|v|f)/", "", clean)
            is_vr = clean.endswith("/vr")
            is_vc = clean.endswith("/vc")
            clean = re.sub(r"/(vr|vc|v)$", "", clean)
            nd = leaf.ndim + (1 if is_vr or is_vc else 0)
            spec = self.param_spec(clean, nd)
            names = list(spec) + [None] * (nd - len(spec))
            if is_vr:
                names = names[:-1]            # mean over last dim
            elif is_vc:
                names = names[:-2] + names[-1:]
            return tuple(names[:leaf.ndim])
        return _map_with_path(one, tree)

    # -- activations ------------------------------------------------------
    def act(self, x, kind: str):
        """``x``: the port's ranks compute on whole leaves, so the
        reference's layout constraint has nothing to place."""
        return x

    def act_spec(self, kind: str, ndim: int, shape=None) -> Optional[tuple]:
        dp = self.dp
        if kind == "residual":
            if (self.seq_parallel and shape is not None
                    and shape[1] % 16 == 0):
                return (dp, "model", None)
            return (dp, None, None)
        if kind == "logits":
            return ((dp, None, "model") if ndim == 3
                    else (dp, None, None, "model"))
        if kind in ("attn_q", "attn_kv"):
            return (dp, None, "model", None)
        if kind == "attn_blk":                 # (B, nblk, blk, H, D)
            return (dp, None, None, "model", None)
        if kind == "ffn_hidden":
            return (dp, None, "model")
        if kind in ("moe_dispatch", "moe_hidden", "moe_combine"):
            return (dp, "model", None, None)
        if kind == "mamba_proj":               # (B, S, channels)
            return (dp, None, "model")
        if kind == "mamba_chunk":              # (B, nc, L, H, P)
            return (dp, None, None, "model", None)
        if kind == "mamba_att":                # (B, nc, L, L, H)
            return (dp, None, None, None, "model")
        return None

    # -- batches ----------------------------------------------------------
    def batch_specs(self, batch_tree) -> Any:
        def one(path, leaf):
            if leaf.shape[0] == 1:             # long_500k: replicate batch
                return ()
            return (self.dp,) + (None,) * (leaf.ndim - 1)
        return _map_with_path(one, batch_tree)

    # -- caches -----------------------------------------------------------
    def cache_specs(self, cache_tree, batch: int) -> Any:
        """Decode-cache specs: sequence-sharded KV (flash-decoding), batch
        over DP; batch=1 shards the sequence over every axis."""
        long_ctx = batch == 1
        all_axes = tuple(self.mesh.axis_names)

        def one(path, leaf):
            p = _path_str(path)
            nd = leaf.ndim
            if p.endswith("pos"):
                return ()
            if re.search(r"(^|/)(k|v)$", p):       # (L_or_G, B, S, H, D)
                if long_ctx:
                    return (None, None, all_axes, None, None)
                return (None, self.dp, "model", None, None)
            if "mamba" in p or "mlstm" in p:       # states: shard heads/dk
                axes = [None] * nd
                for i, s in enumerate(leaf.shape):
                    if s == batch and not long_ctx:
                        axes[i] = self.dp
                        break
                cand = [(s, i) for i, s in enumerate(leaf.shape)
                        if axes[i] is None and s % 16 == 0]
                if cand:
                    axes[max(cand)[1]] = "model"
                return tuple(axes)
            if "slstm" in p:
                axes = [None] * nd
                if not long_ctx and nd >= 2:
                    for i, s in enumerate(leaf.shape):
                        if s == batch:
                            axes[i] = self.dp
                            break
                if nd >= 1 and leaf.shape[-1] % 16 == 0:
                    axes[-1] = "model"
                return tuple(axes)
            return ()
        return _map_with_path(one, cache_tree)

    # -- blocks of a leaf over the grid -------------------------------------
    def _dims(self, spec, shape):
        """Per dimension: (axes, blocks, block size, this rank's block
        index, its start, its length)."""
        out = []
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        for n, entry in zip(shape, spec):
            axes = _dim_axes(entry)
            k, j = 1, 0
            for a in axes:
                k *= self.mesh.axis_size(a)
                j = j * self.mesh.axis_size(a) + self.mesh.axis_index(a)
            bs = -(-n // k) if k > 1 else n
            start = min(j * bs, n)
            out.append((axes, k, bs, j, start, min(bs, n - start)))
        return out

    def block(self, x: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of the whole tensor ``x`` (a view)."""
        for d, (axes, _, _, _, start, length) in enumerate(
                self._dims(spec, x.shape)):
            if axes:
                x = x.narrow(d, start, length)
        return x

    def gather(self, blk: torch.Tensor, spec, shape) -> torch.Tensor:
        """The whole leaf of ``shape`` from every rank's block."""
        x = blk
        for d, (axes, _, bs, _, _, _) in enumerate(self._dims(spec, shape)):
            if not axes:
                continue
            x = _pad(x, d, bs)
            for a in reversed(axes):            # innermost first
                x = self.mesh.all_gather(x, a, d)
            x = x.narrow(d, 0, shape[d])
        return x

    def reduce_block(self, g: torch.Tensor, spec, sum_axes) -> torch.Tensor:
        """This rank's block of the sum of ``g`` (a whole leaf on every
        rank) over the ranks that differ on ``sum_axes``: a reduce-scatter
        over a sum axis that splits the leaf, an all-reduce over one that
        does not, a slice for an axis that splits it but is not summed.
        The block may share ``g``'s storage."""
        x, used = g, set()
        for d, (axes, k, bs, _, _, length) in enumerate(
                self._dims(spec, g.shape)):
            if not axes:
                continue
            x = _pad(x, d, k * bs)
            for a in axes:                      # outermost first
                if a in sum_axes:
                    x = self.mesh.reduce_scatter(x, a, d)
                else:
                    n = x.shape[d] // self.mesh.axis_size(a)
                    x = x.narrow(d, self.mesh.axis_index(a) * n, n)
                used.add(a)
            x = x.narrow(d, 0, length)
        rest = [a for a in sum_axes if a not in used]
        return self.mesh.all_reduce(x.contiguous(), rest)

    def _counted(self, spec) -> bool:
        """Whether this rank counts its block of a leaf in a global sum:
        of the ranks holding the same block, the one at coordinate 0 on
        every axis that does not split the leaf."""
        used = {a for e in spec for a in _dim_axes(e)}
        return all(self.mesh.axis_index(a) == 0
                   for a in self.mesh.axis_names if a not in used)

    def dp_axes(self) -> tuple:
        return _dim_axes(self.dp)

    # -- the sharded train state ---------------------------------------------
    def leaf_specs(self, module) -> list:
        """The spec of each of a training module's ``ref_leaves``."""
        return [self.param_spec(_path_str(leaf.path), leaf.value.ndim)
                for leaf in module.ref_leaves]

    @torch.no_grad()
    def shard(self, state, optimizer):
        """Shard a ``TrainState`` in place: ``state.master`` becomes this
        rank's blocks of the module's fp32 masters (a dict tree as
        ``leaf_tree``) and ``state.opt`` ``optimizer.init`` of the blocks.
        The module keeps whole leaves: each step gathers the masters into
        them."""
        self._take_masters(state)
        state.opt = optimizer.init(state.master)
        return state

    def _take_masters(self, state) -> None:
        """``state.master``: clones of this rank's blocks of the module's
        leaves."""
        from repro_torch.models.common import leaf_tree
        module = state.params
        blocks = {leaf.path: self.block(leaf.value, spec).clone()
                  for leaf, spec in zip(module.ref_leaves,
                                        self.leaf_specs(module))}
        state.master = _tree_from_paths(leaf_tree(module), blocks)

    @torch.no_grad()
    def gather_params(self, state, cfg) -> None:
        """Write the whole masters into the module's leaves: their compute
        dtype cast gathered (``cfg.cast_params_once``; the values the
        module's cast view then reads), else the fp32 masters."""
        module = state.params
        masters = _leaves(state.master)
        cast = _cast_paths(module) if cfg.cast_params_once else ()
        for leaf, spec, m in zip(module.ref_leaves,
                                 self.leaf_specs(module), masters):
            if leaf.path in cast:
                m = m.to(cfg.compute_dtype)
            leaf.value.copy_(self.gather(m, spec, leaf.value.shape))

    @torch.no_grad()
    def reduce_grads(self, module, batch_split: bool) -> dict:
        """This rank's blocks of the mean gradient over the data-parallel
        ranks (a dict tree as the masters)."""
        from repro_torch.models.common import leaf_tree
        dp = self.dp_axes() if batch_split else ()
        n = math.prod(self.mesh.axis_size(a) for a in dp)
        blocks = {}
        for leaf, spec in zip(module.ref_leaves, self.leaf_specs(module)):
            g = self.reduce_block(leaf.grad, spec, dp)
            blocks[leaf.path] = g.div_(n) if n > 1 else g
        return _tree_from_paths(leaf_tree(module), blocks)

    def batch_block(self, batch: dict) -> tuple[dict, bool]:
        """(this rank's block of the batch, whether it was split)."""
        specs = self.batch_specs(batch)
        split = any(s for s in specs.values())
        n = math.prod(self.mesh.axis_size(a) for a in self.dp_axes())
        out = {}
        for k, x in batch.items():
            if specs[k] and x.shape[0] % n:
                raise ValueError(f"batch {k!r} of {x.shape[0]} rows does not "
                                 f"split over {n} data-parallel ranks")
            out[k] = self.block(x, specs[k])
        return out, split

    def layout(self, module) -> "PolicyLayout":
        return PolicyLayout(self, self.leaf_specs(module),
                            [tuple(leaf.value.shape)
                             for leaf in module.ref_leaves])

    @torch.no_grad()
    def state_tree(self, state, optimizer, device="cpu") -> tuple:
        """The canonical, unsharded ``(params, opt, step)`` tree on
        ``device``, gathered one leaf at a time (a collective: every rank
        calls it); ``optimizer`` is the one the state was sharded with."""
        from repro_torch.models.common import leaf_tree
        module = state.params
        blocks = {}
        for leaf, spec, m in zip(module.ref_leaves, self.leaf_specs(module),
                                 _leaves(state.master)):
            blocks[leaf.path] = self.gather(m, spec, leaf.value.shape
                                            ).to(device)
        params = _tree_from_paths(leaf_tree(module), blocks)
        whole = self.canonical_template(state, optimizer)[1]
        ospecs = self.tree_specs({"1": whole})["1"]
        opt = _map3(lambda b, s, w: self.gather(b, s, w.shape).to(device)
                    if b.ndim else b, state.opt, ospecs, whole)
        return params, opt, state.step

    def canonical_template(self, state, optimizer) -> tuple:
        """``state_tree``'s structure with whole shapes
        (``device="meta"``): the template a checkpoint restores into."""
        from repro_torch.models.common import leaf_tree
        tree = leaf_tree(state.params)
        params = _map2(lambda v, _: torch.empty(v.shape, dtype=v.dtype,
                                                device="meta"), tree, tree)
        return params, optimizer.init(params), state.step

    @torch.no_grad()
    def load_state_tree(self, state, tree):
        """Restore a canonical tree (``state_tree``, a checkpoint of either
        package) into a sharded state of this grid: the module's leaves
        whole, the masters' and the optimizer state's blocks."""
        params, opt, step = tree
        module = state.params
        dev = module.ref_leaves[0].value.device
        for leaf, src in zip(module.ref_leaves, _leaves(params)):
            leaf.value.copy_(src)
        self._take_masters(state)
        ospecs = self.tree_specs({"1": opt})["1"]
        state.opt = _map2(lambda x, s: self.block(x, s).to(dev).clone()
                          if isinstance(x, torch.Tensor) and x.ndim
                          else torch.as_tensor(x, dtype=torch.int32).cpu(),
                          opt, ospecs)
        state.step = torch.as_tensor(step, dtype=torch.int32).cpu()
        return state


class PolicyLayout:
    """The reductions the optimizers take over a sharded tree: the global
    gradient norm (one all-reduce of the per-leaf sums, a leaf held by
    several ranks counted once) and, per leaf, means over dimensions that
    may be split (all-reduced sums over the split's axes; the plain mean
    where the dimension is whole)."""

    def __init__(self, policy: ShardingPolicy, specs: list, shapes: list):
        self.policy, self.specs, self.shapes = policy, specs, shapes

    def global_norm(self, grads) -> torch.Tensor:
        leaves = _leaves(grads)
        sums = torch.stack([
            torch.sum(torch.square(g.float())) if self.policy._counted(s)
            else g.new_zeros((), dtype=torch.float32)
            for g, s in zip(leaves, self.specs)])
        self.policy.mesh.all_reduce(sums)
        return torch.sqrt(sum(sums.unbind()))

    def leaf(self, i: int) -> "_LeafLayout":
        return _LeafLayout(self.policy, self.specs[i], self.shapes[i])


class _LeafLayout:
    def __init__(self, policy, spec, shape):
        self.mesh = policy.mesh
        self.shape = shape
        self.axes = [_dim_axes(e) for e in
                     tuple(spec) + (None,) * (len(shape) - len(spec))]

    def _split(self, axes) -> list:
        return [a for a in axes if self.mesh.axis_size(a) > 1]

    def mean(self, x, dim: int, leaf_dim: Optional[int] = None,
             keepdim: bool = False) -> torch.Tensor:
        """The mean over ``dim`` of the whole leaf's values, where ``dim``
        of ``x`` is the leaf's dimension ``leaf_dim`` (``dim`` itself by
        default)."""
        ld = dim if leaf_dim is None else leaf_dim
        axes = self._split(self.axes[ld])
        if not axes:
            return x.mean(dim, keepdim=keepdim)
        s = self.mesh.all_reduce(x.sum(dim, keepdim=keepdim), axes)
        return s / self.shape[ld]

    def mean_all(self, x) -> torch.Tensor:
        axes = self._split([a for ax in self.axes for a in ax])
        if not axes:
            return torch.mean(x)
        return self.mesh.all_reduce(x.sum(), axes) / math.prod(self.shape)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _pad(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``x`` zero-padded at the end of ``dim`` to ``size``."""
    short = size - x.shape[dim]
    if short <= 0:
        return x
    pad = [0, 0] * (x.ndim - 1 - dim) + [0, short]
    return F.pad(x, pad)


def _cast_paths(module) -> set:
    """The paths of the leaves the module's cast view reads in the compute
    dtype (the reference's ``cast_params`` casts them)."""
    from repro_torch.models.common import _owners
    return {path for path, _, owner, name in _owners(module)
            if getattr(owner, name).ref_cast
            and getattr(owner, name).dtype == torch.float32}


def _tree_from_paths(template: dict, by_path: dict, path=()) -> dict:
    if isinstance(template, dict):
        return {k: _tree_from_paths(v, by_path, path + (k,))
                for k, v in template.items()}
    return by_path[path]


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _map3(fn, a, b, c):
    if isinstance(a, dict):
        return {k: _map3(fn, a[k], b[k], c[k]) for k in a}
    return fn(a, b, c)
