"""Gradient compression for the data-parallel axis: an int8 quantised
all-reduce with error feedback (1-bit-Adam-style residual correction).

Counterpart of ``repro/distributed/compression.py``.  An fp32 ring
all-reduce moves about 2 x 4 bytes an element; quantise, all-gather the
int8 values and one fp32 scale per rank, then dequantise and sum locally
moves about 1 byte an element, at the price of quantisation noise that the
error-feedback residual re-injects at the next call (so the accumulated
mean is unbiased).  The reference runs it inside ``shard_map`` over an
axis name; the port takes the axis's process group (a ``RankGrid``'s
``groups[axis]``; None without ``torch.distributed``, a group of one).
The dequantised values are summed in rank order, so every rank, and a
card and the CPU, get the same bits.
"""
from __future__ import annotations

import torch


def _quantize_int8(x: torch.Tensor):
    """(int8 values, fp32 scale): scale = max(|x|, 1e-12) / 127 and the
    values rounded half to even (``torch.round``, as ``jnp.round``)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(ranks, *x.shape): every rank's ``x`` in rank order."""
    import torch.distributed as dist
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return x[None].clone()
    n = dist.get_world_size(group)
    out = x.new_empty((n,) + tuple(x.shape))
    dist.all_gather_into_tensor(out, x[None].contiguous(), group=group)
    return out


def compressed_allreduce_int8(x: torch.Tensor, group=None,
                              error: torch.Tensor | None = None):
    """Mean over the ranks of ``group`` of their ``x``, int8 on the wire.

    Returns (mean in ``x``'s dtype, new error): ``error`` is the previous
    call's residual, added to ``x`` before quantising."""
    xf = x.float()
    if error is not None:
        xf = xf + error
    q, scale = _quantize_int8(xf)
    new_error = xf - q.float() * scale                  # feedback residual
    qg = _all_gather(q, group)                           # (G, ...)
    sg = _all_gather(scale.reshape(1), group)[:, 0]      # (G,)
    n = qg.shape[0]
    total = qg[0].float() * sg[0]
    for i in range(1, n):
        total = total + qg[i].float() * sg[i]
    return (total / n).to(x.dtype), new_error


def compressed_tree_allreduce(grads, group=None, error_tree=None):
    """The dict-tree version, threading each leaf's error feedback:
    (tree of means, tree of new errors)."""
    if isinstance(grads, dict):
        errs = error_tree if error_tree is not None else {}
        out = {k: compressed_tree_allreduce(v, group, errs.get(k))
               for k, v in grads.items()}
        return ({k: m for k, (m, _) in out.items()},
                {k: e for k, (_, e) in out.items()})
    return compressed_allreduce_int8(grads, group, error_tree)
