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
bit-identical no matter which dynamic tree shape the blocks took. The scale
is one a group of tensors: the reference takes one a pytree leaf, and its
leaves stack every layer of a layer period, so the train step groups the
port's per-layer tensors by the reference leaf they belong to
(:func:`repro_torch.convert.reference_leaves`); with no groups each tensor
is its own. The maxima of all groups travel in one all-reduce per process
group and stay on the tensors' device: the host never waits for them.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed import ProcessGroup

from ...kernels import dequantize, fixed_point_scale, quantize
from .congestion import round_robin_roots
from .trees import (hierarchical_allreduce, multi_root_tree_allreduce, psum,
                    ring_allreduce)

DEFAULT_BLOCKS = 16


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nest of mappings, lists and tuples, in the order
    :func:`tree_map` visits them."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


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
                    outer_group: Optional[ProcessGroup],
                    inplace: bool = False) -> torch.Tensor:
    if mode == "canary":
        y = multi_root_tree_allreduce(x, group, axis_size, roots, inplace)
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


def _group_index(grads: Any, groups: Optional[Sequence[Sequence[Any]]]
                 ) -> List[int]:
    """The group of each tensor of ``grads``, in :func:`tree_leaves` order:
    its own without ``groups``; else ``grads`` is a flat mapping and
    ``groups`` partition its keys."""
    if groups is None:
        return list(range(len(tree_leaves(grads))))
    if not isinstance(grads, Mapping):
        raise TypeError("groups name keys of a flat mapping of tensors")
    where = {key: j for j, keys in enumerate(groups) for key in keys}
    if sum(len(keys) for keys in groups) != len(where) \
            or set(where) != set(grads) or not all(groups):
        raise ValueError(f"groups must partition the keys of grads: "
                         f"{sorted(set(grads) ^ set(where))} differ, or a "
                         f"key is in two groups, or a group is empty")
    return [where[key] for key in grads]


def fixed_point_scales(grads: Any, process_groups: Sequence[ProcessGroup], *,
                       bits: int, world: int,
                       groups: Optional[Sequence[Sequence[Any]]] = None
                       ) -> List[torch.Tensor]:
    """The shared fixed-point scale of each tensor of ``grads`` (in
    :func:`tree_leaves` order), a 0-d float32 tensor on its device:
    ``fixed_point_scale`` of the max |x| over its group's tensors and over
    every rank of ``process_groups``.

    One ``aminmax`` a tensor (max and min are exact in any float dtype, so
    this is ``max(abs(f32(x)))``), the max over each group, and one
    ``all_reduce(MAX)`` of the vector of all group maxima per process group
    (``lax.pmax`` of each leaf's max, every leaf at once).
    """
    index = _group_index(grads, groups)
    members: List[List[torch.Tensor]] = [[] for _ in range(max(index) + 1)]
    for j, x in zip(index, tree_leaves(grads)):
        lo, hi = torch.aminmax(x)
        members[j].append(torch.maximum(hi, -lo).to(torch.float32))
    # built on the device from the maxima: no index tensor is copied over
    # from the host, so the host never waits for the card
    gmax = torch.stack([torch.stack(m).max() for m in members])
    for g in process_groups:
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=g)
    scales = fixed_point_scale(gmax, bits=bits, world=world)
    return [scales[j] for j in index]


def canary_allreduce_tree(grads: Any, *, group: ProcessGroup, axis_size: int,
                          roots: Optional[Sequence[int]] = None,
                          num_blocks: int = DEFAULT_BLOCKS,
                          mode: str = "canary",
                          outer_group: Optional[ProcessGroup] = None,
                          fixed_point: bool = False,
                          fp_bits: int = 24,
                          groups: Optional[Sequence[Sequence[Any]]] = None
                          ) -> Any:
    """Allreduce every tensor of ``grads`` over ``group`` (+``outer_group``).

    ``grads``: a tensor or a nest of mappings, lists and tuples of tensors;
    the result has the same nest. ``axis_size`` is ``group``'s size and
    ``roots`` are ranks of ``group``.
    mode: canary (multi-root trees) | ring (RS+AG) | hierarchical | psum.
    ``groups`` (fixed point only): lists of keys of a flat mapping
    ``grads`` whose tensors share one scale (see
    :func:`fixed_point_scales`); each tensor still rides its own trees.
    A dict ``grads`` gives its entries up: each is taken out of it as its
    result is made, so a tensor no one else holds is freed then, not after
    the last one (the dict is left empty; a caller that keeps its tensors
    passes a copy, ``dict(grads)``).
    """
    if axis_size != dist.get_world_size(group):
        raise ValueError(f"axis_size {axis_size} != the group's size "
                         f"{dist.get_world_size(group)}")
    if roots is None:
        roots = round_robin_roots(num_blocks, axis_size)
    process_groups = [group] if outer_group is None else [group, outer_group]
    world = axis_size
    if outer_group is not None:
        world *= dist.get_world_size(outer_group)

    def each(fn):
        """``fn`` on each tensor, handed over in a list ``fn`` empties: a
        dict's entry is taken out first, so the list may hold its only
        reference and ``fn`` can free the tensor before it returns."""
        if not isinstance(grads, dict):
            return tree_map(lambda t: fn([t]), grads)
        return {key: fn([grads.pop(key)])
                if isinstance(grads[key], torch.Tensor)
                else tree_map(lambda t: fn([t]), grads.pop(key))
                for key in list(grads)}

    def reduce(box):
        return _leaf_allreduce(box.pop(), group, axis_size, roots, mode,
                               outer_group)

    if not (fixed_point and mode == "canary"):
        return each(reduce)
    # quantize -> integer reduce -> dequantize (``fixed_point_allreduce_wrap``)
    scales = iter(fixed_point_scales(grads, process_groups, bits=fp_bits,
                                     world=world, groups=groups))

    def one(box):
        x = box.pop()
        s, dtype = next(scales), x.dtype
        q = quantize(x, s)
        del x       # a tensor given up is freed before its sum is made
        q = _leaf_allreduce(q, group, axis_size, roots, mode, outer_group,
                            inplace=True)   # the trees sum into q itself
        y = dequantize(q, s)
        del q
        return y.to(dtype)

    return each(one)
