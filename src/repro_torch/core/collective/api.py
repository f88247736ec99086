"""Public allreduce API (port of ``repro/core/collective/api.py``):
Canary-style gradient synchronization for name -> tensor mappings.

``canary_allreduce_tree``: reduce every gradient over the data-parallel
process group, Canary-style — each tensor is flattened into blocks, each
block rides its own reduction tree (root chosen by the congestion oracle),
and two-level meshes reduce hierarchically (trees inside the inner group,
then across the outer one).

Optional fixed-point mode quantizes each tensor to int32 before reduction
(paper §6: switch ALUs are integer-only), through the port's quantize and
dequantize kernels. Integer addition is associative, so the result is
bit-identical no matter which dynamic tree shape the blocks took. The
global max |x| and the scale stay 0-d tensors on the tensor's device: the
host never waits for them.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed import ProcessGroup

from ...kernels.ops import fixed_point_allreduce_wrap
from .congestion import round_robin_roots
from .trees import (hierarchical_allreduce, multi_root_tree_allreduce, psum,
                    ring_allreduce)

DEFAULT_BLOCKS = 16


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` on every tensor of a nest of mappings, lists and tuples (the
    port's pytree), keeping the nest."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"not a tensor, mapping, list or tuple: {type(tree)}")


def _leaf_allreduce(x: torch.Tensor, group: ProcessGroup, axis_size: int,
                    roots: Sequence[int], mode: str,
                    outer_group: Optional[ProcessGroup]) -> torch.Tensor:
    if mode == "canary":
        y = multi_root_tree_allreduce(x, group, axis_size, roots)
        return psum(y, outer_group) if outer_group is not None else y
    if mode == "ring":
        y = ring_allreduce(x, group)
        return psum(y, outer_group) if outer_group is not None else y
    if mode == "hierarchical":
        if outer_group is None:
            return ring_allreduce(x, group)
        return hierarchical_allreduce(x, group, outer_group)
    if mode == "psum":
        y = psum(x, group)
        return psum(y, outer_group) if outer_group is not None else y
    raise ValueError(f"unknown grad-sync mode {mode}")


def global_abs_max(x: torch.Tensor, groups) -> torch.Tensor:
    """max |x| over every rank of ``groups``, in float32, as a 0-d tensor on
    ``x``'s device (``lax.pmax(max(abs(f32(x))))``; max and min are exact in
    any float dtype, so one ``aminmax`` pass over ``x`` gives the same bits
    as the float32 upcast)."""
    lo, hi = torch.aminmax(x)
    gmax = torch.maximum(hi, -lo).to(torch.float32)
    for g in groups:
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=g)
    return gmax


def canary_allreduce_tree(grads: Any, *, group: ProcessGroup, axis_size: int,
                          roots: Optional[Sequence[int]] = None,
                          num_blocks: int = DEFAULT_BLOCKS,
                          mode: str = "canary",
                          outer_group: Optional[ProcessGroup] = None,
                          fixed_point: bool = False,
                          fp_bits: int = 24) -> Any:
    """Allreduce every tensor of ``grads`` over ``group`` (+``outer_group``).

    ``grads``: a tensor or a nest of mappings, lists and tuples of tensors;
    the result has the same nest. ``axis_size`` is ``group``'s size and
    ``roots`` are ranks of ``group``.
    mode: canary (multi-root trees) | ring (RS+AG) | hierarchical | psum.
    """
    if axis_size != dist.get_world_size(group):
        raise ValueError(f"axis_size {axis_size} != the group's size "
                         f"{dist.get_world_size(group)}")
    if roots is None:
        roots = round_robin_roots(num_blocks, axis_size)
    groups = [group] if outer_group is None else [group, outer_group]
    world = axis_size
    if outer_group is not None:
        world *= dist.get_world_size(outer_group)

    def reduce(x):
        return _leaf_allreduce(x, group, axis_size, roots, mode, outer_group)

    def one(x):
        if fixed_point and mode == "canary":
            return fixed_point_allreduce_wrap(
                x, reduce, global_abs_max(x, groups), bits=fp_bits,
                world=world)
        return reduce(x)

    return tree_map(one, grads)
