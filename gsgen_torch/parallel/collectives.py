"""The collectives of the sharded renders, with their gradients.

``shard_map`` autodiff gives the JAX package each collective's transpose;
in eager PyTorch they are written out as autograd functions, one per
pattern the sharded renders use:

* :func:`replicated_input`: a tensor every rank holds whole (the
  Gaussians of a tile-sharded render, its ``mean2d`` tap).  Forward the
  identity; backward an all-reduce SUM over the group, the psum that JAX
  takes for a replicated input.
* :func:`gather_rows`: the all-gather of sharded scene rows along dim 0
  (``_gather_params`` of the JAX package).  Backward a reduce-scatter SUM:
  each rank receives its own rows' gradient, summed over every slab.
* :func:`gather_slabs`: the all-gather of a slab output (image rows, a
  rank's views).  Every rank computes the same loss on the gathered whole,
  so each gets the whole cotangent; backward keeps this rank's rows of it,
  the transpose of JAX's ``out_specs=P(axis)``.  (A summing backward, as
  ``torch.distributed.nn.functional.all_gather`` has, would count the loss
  once per rank.)
* :func:`all_reduce` / :func:`reduce_max`: statistics without gradient
  (duplicate counts SUM; ``radii2d`` and ``visible`` MAX, ``visible``
  through int32).

Every collective runs on the tensor itself, whatever the group's backend:
gloo takes each of them on CUDA tensors too (torch 2.11 on the H100
machine), as NCCL does.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``x`` reduced over ``group`` (a new tensor, without gradient)."""
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=op, group=group)
    return y


def broadcast(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` overwritten, in place, by the group's first rank's."""
    dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        flat = all_reduce(flat, ctx.group)
        parts = torch.split(flat, [g.numel() for g in gs])
        return (None,) + tuple(p.view_as(g) for p, g in zip(parts, gs))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM,
                                   group=ctx.group)
        return out, None


class _GatherSlabs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rows = x.shape[0]
        ctx.rank = dist.get_rank(group)
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        r = ctx.rank * ctx.rows
        return g[r:r + ctx.rows], None


def replicated_input(group, tensors: Dict[str, Optional[torch.Tensor]]
                     ) -> Dict[str, Optional[torch.Tensor]]:
    """The same tensors, whose gradients are summed over ``group`` (one
    all-reduce for all of them); None values stay None."""
    names = [k for k, v in tensors.items() if v is not None]
    outs: List[torch.Tensor] = _SumGrad.apply(
        group, *(tensors[k] for k in names))
    return {**tensors, **dict(zip(names, outs))}


@torch.no_grad()
def sum_tensors(tensors: Dict[str, torch.Tensor], group
                ) -> Dict[str, torch.Tensor]:
    """Each tensor summed over ``group``, in one all-reduce of them
    flattened (as float32)."""
    flat = torch.cat([v.reshape(-1).to(torch.float32)
                      for v in tensors.values()])
    parts = torch.split(all_reduce(flat, group),
                        [v.numel() for v in tensors.values()])
    return {k: p.view_as(v).to(v.dtype)
            for (k, v), p in zip(tensors.items(), parts)}


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather along dim 0; the gradient is reduce-scattered (SUM)."""
    return _GatherRows.apply(x, group)


def gather_slabs(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather along dim 0; the gradient of this rank's rows is its
    rows of the (replicated) cotangent."""
    return _GatherSlabs.apply(x, group)


def gather_flags(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather of a bool tensor along dim 0 (no gradient)."""
    return _gather(x.to(torch.uint8), group).to(torch.bool)


@torch.no_grad()
def reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """MAX over ``group``; a bool tensor goes through int32."""
    if x.dtype == torch.bool:
        return all_reduce(x.to(torch.int32), group,
                          dist.ReduceOp.MAX).to(torch.bool)
    return all_reduce(x, group, dist.ReduceOp.MAX)
