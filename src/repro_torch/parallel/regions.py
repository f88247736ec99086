"""Autograd-aware collectives for layers that run across ranks.

Every rank of a model group runs the same program on the same tokens and
takes the same loss, as the reference's devices do under ``shard_map``;
a parameter or activation that every rank holds must come out of the
backward pass with the whole gradient on every rank, once. These are the
conjugate pairs of Megatron-LM (Shoeybi et al. 2019, section 3) that make
it so:

* :func:`copy_to` — forward identity, backward all-reduce: an input that
  each rank uses for its own part of the work (tokens dispatched to its
  local experts, the router's weight);
* :func:`reduce_from` — forward all-reduce, backward identity: the sum of
  the ranks' partial outputs;
* :func:`mean_over` — the mean of the ranks' values, each rank's share of
  the gradient ``1 / n``;
* :func:`sum_over` — the sum of the ranks' values where each rank uses
  the sum for its own part of the work (``psum``): backward, the sum of
  the ranks' gradients;
* :func:`gather_from` — forward all-gather along a dim, backward this
  rank's own slice;
* :func:`shard_of` — this rank's block along a dim of a tensor that every
  rank holds whole, its gradient all-gathered back to the whole tensor;
* :func:`all_to_all` — equal chunks of dim 0 exchanged (chunk ``j`` to
  rank ``j``); its backward is the same exchange;
* :func:`gather_rows` — rows gathered over the data groups (outermost
  first, data-major), backward a reduce-scatter: every rank's loss may
  reach every row.

Sums run in float32 and are cast back, so a bf16 tensor's sum rounds once.
On a group of one rank each is the identity.

:func:`shard_map` is the reference's ``jax.shard_map`` boundary around a
body written on each rank's local tensors with these collectives.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.autograd import Function
from torch.distributed import ProcessGroup
from torch.distributed.tensor import DTensor, Partial

from .context import get_parallel_context
from .sharding import P, param_placements


def _size(group: ProcessGroup) -> int:
    return dist.get_world_size(group)


def _sum(t: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    out = t.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


def _gather(t: torch.Tensor, group: ProcessGroup, dim: int) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


class _CopyTo(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOver(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = _size(group)
        return _sum(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _SumOver(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _GatherFrom(Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.len = group, dim, x.shape[dim]
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        lo = dist.get_rank(ctx.group) * ctx.len
        return g.narrow(ctx.dim, lo, ctx.len).contiguous(), None, None


class _ShardOf(Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        rows = x.shape[dim] // _size(group)
        return x.narrow(dim, dist.get_rank(group) * rows, rows)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def _exchange(t: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _AllToAll(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _GatherRows(Function):
    @staticmethod
    def forward(ctx, x, groups, index):
        ctx.groups, ctx.index, ctx.rows = groups, index, x.shape[0]
        for g in reversed(groups):              # innermost axis first
            x = _gather(x, g, 0)
        return x

    @staticmethod
    def backward(ctx, g):
        for grp in ctx.groups:
            g = _sum(g, grp)
        return g.narrow(0, ctx.index * ctx.rows, ctx.rows), None, None


def copy_to(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    return x if _size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    return x if _size(group) == 1 else _ReduceFrom.apply(x, group)


def mean_over(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    return x if _size(group) == 1 else _MeanOver.apply(x, group)


def sum_over(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    return x if _size(group) == 1 else _SumOver.apply(x, group)


def gather_from(x: torch.Tensor, group: ProcessGroup, dim: int
                ) -> torch.Tensor:
    return x if _size(group) == 1 else _GatherFrom.apply(x, group, dim)


def shard_of(x: torch.Tensor, group: ProcessGroup, dim: int = 0
             ) -> torch.Tensor:
    """Block ``r`` of ``x``'s equal blocks along ``dim`` on group rank
    ``r``."""
    return x if _size(group) == 1 else _ShardOf.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    return x if _size(group) == 1 else _AllToAll.apply(x, group)


def exchange(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """:func:`all_to_all` of a tensor that carries no gradient (ids)."""
    return x if _size(group) == 1 else _exchange(x, group)


def gather_rows(x: torch.Tensor, groups: Sequence[ProcessGroup],
                index: int) -> torch.Tensor:
    """Every data rank's rows of ``x`` in data-major order; ``index`` is
    this rank's data-parallel index (its rows' block)."""
    return _GatherRows.apply(x, tuple(groups), index)


def _model_dim(spec: P, axis: str):
    """The dim ``spec`` splits over mesh axis ``axis``, or ``None``."""
    for d, axes in enumerate(spec):
        if axes == axis or (isinstance(axes, tuple) and axis in axes):
            return d
    return None


def shard_map(body: Callable, in_specs: Sequence[P],
              out_specs: Sequence[P],
              out_shapes: Optional[Sequence[Sequence[int]]] = None
              ) -> Callable:
    """The reference's ``jax.shard_map(body, mesh, in_specs, out_specs)``
    on the installed context's mesh: ``body`` runs on each rank's local
    tensors, with the collectives of this module over the context's model
    group, and returns a tuple.

    * On DTensors (the dry run), each input is redistributed to the
      placements of its spec on the inputs' mesh (the context's, or its
      model axis alone under an explicit gradient sync) and handed in as
      its local tensor, whose
      gradient is a partial sum over every mesh dim its spec does not
      split (the transpose of ``shard_map``'s unmentioned axes); each
      output is the DTensor of the local ones at its spec, of the global
      shape ``out_shapes`` gives (needed where a spec splits a dim its
      axes do not divide: the local shares are then uneven, as
      DTensor's, GSPMD's padded ones); else of the local shapes times the
      splits. A spec may leave the batch whole (``P(None, ...)``) where it
      does not split over the data axes.
    * On plain tensors (a rank a process: each rank holds its own rows
      over the data axes, and every tensor whole over the model group),
      an input whose spec splits a dim over the model axis comes in as
      this rank's block (:func:`shard_of`), any other through
      :func:`copy_to`; an output whose spec splits a dim over the model
      axis is gathered along it (:func:`gather_from`). Over the data axes
      nothing moves: the train step averages the gradients there.
    """
    def run(*args):
        ctx = get_parallel_context()
        axis = ctx.model_axis
        if not any(isinstance(a, DTensor) for a in args):
            g = ctx.model_group
            ins = [copy_to(a, g) if _model_dim(s, axis) is None
                   else shard_of(a, g, _model_dim(s, axis))
                   for a, s in zip(args, in_specs)]
            return tuple(o if _model_dim(s, axis) is None
                         else gather_from(o, g, _model_dim(s, axis))
                         for o, s in zip(body(*ins), out_specs))
        mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
        ins = []
        for a, s in zip(args, in_specs):
            pl = param_placements(s, mesh)
            ins.append(a.redistribute(mesh, pl).to_local(grad_placements=[
                p if p.is_shard() else Partial() for p in pl]))
        shapes = out_shapes or [None] * len(out_specs)
        return tuple(DTensor.from_local(
            o, mesh, param_placements(s, mesh), run_check=False,
            shape=None if n is None else torch.Size(n),
            stride=None if n is None
            else torch.empty(n, device="meta").stride())
            for o, s, n in zip(body(*ins), out_specs, shapes))
    return run
