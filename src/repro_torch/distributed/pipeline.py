"""Pipeline parallelism over an axis of a rank grid (GPipe schedule).

Counterpart of ``repro/distributed/pipeline.py``.  The layer stack (L, ...)
is split into S contiguous stages, one per rank of the stage axis, and a
global batch into M microbatches.  At step t of the S + M - 1 steps,
stage s runs microbatch t - s when it is live, then every stage sends its
activations to stage s + 1 (``isend``/``irecv`` over the axis's process
group, in place of the reference's ``ppermute``; stage 0 receives zeros).
The last stage's outputs are broadcast to every rank of the axis, as the
reference's ``all_gather(...)[n_stages - 1]`` gives them.  Bubble
fraction (S - 1) / (S + M - 1).

``pipeline_apply`` is the forward executor (inference, evaluation).
"""
from __future__ import annotations

import torch

from repro_torch.optim.optimizers import _leaves, _map


def pipeline_apply(mesh, stage_axis: str, block_fn, stacked_params,
                   x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """Run ``x`` through the whole stacked layer sequence, its stages over
    ``stage_axis`` of ``mesh`` (a ``RankGrid``).

    block_fn(params_slice, h) -> h applies ONE layer.
    stacked_params: dict tree with the layer axis L in front
    (L % n_stages == 0), whole on every rank.
    x: (B, ...) global batch (B % n_micro == 0), the same on every rank.
    """
    n_stages = mesh.shape[stage_axis]
    leaves = _leaves(stacked_params)
    L = leaves[0].shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers do not split over {n_stages} stages")
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} is not a multiple of {n_micro} "
                         "microbatches")
    mb, per = B // n_micro, L // n_stages
    sid = mesh.axis_index(stage_axis)
    local = _map(lambda a: a[sid * per:(sid + 1) * per], stacked_params)
    micros = x.reshape((n_micro, mb) + tuple(x.shape[1:]))

    def layers(h):
        for i in range(per):
            h = block_fn(_map(lambda a: a[i], local), h)
        return h

    group = mesh.groups[stage_axis]
    stride = 1
    for a, n in zip(reversed(mesh.axis_names), reversed(mesh.sizes)):
        if a == stage_axis:
            break
        stride *= n
    inbuf = torch.zeros_like(micros[0])
    outs = torch.zeros_like(micros)
    for t in range(n_stages + n_micro - 1):
        h_in = micros[min(t, n_micro - 1)] if sid == 0 else inbuf
        live = 0 <= t - sid < n_micro
        h_out = layers(h_in) if live else h_in
        done = t - (n_stages - 1)
        if sid == n_stages - 1 and 0 <= done < n_micro:
            outs[done] = h_out
        inbuf = _shift(h_out, sid, n_stages, group, mesh.rank, stride)
    if group is not None:
        import torch.distributed as dist
        src = mesh.rank + (n_stages - 1 - sid) * stride
        dist.broadcast(outs, src, group=group)
    return outs.reshape(x.shape)


def _shift(h: torch.Tensor, sid: int, n_stages: int, group, rank: int,
           stride: int) -> torch.Tensor:
    """Stage s's ``h`` sent to stage s + 1: what this stage receives from
    s - 1 (zeros on stage 0)."""
    recv = torch.zeros_like(h)
    if group is None or n_stages == 1:
        return recv
    import torch.distributed as dist
    ops = []
    if sid < n_stages - 1:
        ops.append(dist.P2POp(dist.isend, h.contiguous(), rank + stride,
                              group))
    if sid > 0:
        ops.append(dist.P2POp(dist.irecv, recv, rank - stride, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv

