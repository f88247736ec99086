"""Layout hooks: where the model code's own operations, on DTensors,
would move what GSPMD leaves in place. Each returns ``None`` (or does the
plain operation) on a plain tensor, so the model's single-rank path is
unchanged.

* :func:`kv_by_query_heads`: grouped-query K/V laid out by the query's
  heads over the model axis;
* :func:`write_slot`: a decode step's K/V written into a cache that the
  model axis splits along its slots;
* :func:`redistribute_over_data`: a tensor moved from one split dim to
  another over the data axes at once, where they are two mesh dims;
* :func:`split_as_batch`: a tensor the model builds whole over the batch
  (the default positions) laid out as the activations' batch is;
* :func:`keep_d_split`: an encoder-decoder's layers, where GSPMD keeps
  the model dim d split over the model axis (read by the dry run's product
  layout through :func:`d_split_kept`).

Where the model axis divides the query heads but not the key heads (llama's
32 / 8, glm4's 32 / 2 or nemotron's 96 / 8 heads on 16 ranks) and leaves
the batch whole (a prefill's two sequences a data rank, or a two-pod step's
eight), GSPMD splits the query heads over the model axis and each rank
projects only the key and value heads of its own query heads' groups:
their sharding propagates back from the attention into the projections.
DTensor has no placement for "key head ``g`` on the ranks of group ``g``",
so :func:`kv_by_query_heads` gives K and V repeated to the query's heads,
``(B, S, H, hd)``, split over the model axis as q is: a true DTensor whose
local block each rank computes from its groups' columns of ``wk`` and
``wv`` alone and repeats in place. The attention then runs by heads, each
rank's query heads against its own keys. The backward sums the repeats,
and the weights' gradients are partial sums over the model axis (zeros
outside a rank's groups), reduced as the parameters' layouts ask.

On a plain tensor, or where the layout does not apply, it returns
``None`` and the caller projects K and V itself.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch.autograd import Function
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .context import get_parallel_context


def _groups(x, H: int, KV: int) -> Optional[Tuple[int, int, int, int]]:
    """``(m, first, kv, reps)``: the model axis's mesh dim ``m``; this
    rank's query heads need the key heads ``[first, first + kv)``, each
    ``reps`` times. ``None`` where the layout does not apply."""
    ctx = get_parallel_context()
    if ctx is None or not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    if ctx.model_axis not in names or ctx.sequence_parallel:
        return None
    m = names.index(ctx.model_axis)
    n = mesh.size(m)
    split = 1
    for i, p in enumerate(x.placements):
        if i != m and p.is_shard(0):
            split *= mesh.size(i)
    if n == 1 or H % n or KV % n == 0 or (x.shape[0] // split) % n == 0 \
            or not all(p.is_replicate() or (i != m and p.is_shard(0))
                       for i, p in enumerate(x.placements)):
        return None
    share, group = H // n, H // KV
    if share % group and group % share:
        return None
    first = mesh.get_coordinate()[m] * share // group
    kv = max(1, share // group)
    return m, first, kv, share // kv


class _KVByQueryHeads(Function):
    """x ``(B, S, d)`` and ``w`` ``(d, KV, hd)`` DTensors -> ``x @ w``
    repeated to ``H`` heads, split over the model axis (see the module)."""

    @staticmethod
    def forward(ctx, x, w, H, at):
        m, first, kv, reps = at
        mesh = x.device_mesh
        wl = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        wg = wl.narrow(1, first, kv)
        xl = x.to_local()
        local = torch.einsum("bsd,dhx->bshx", xl, wg) \
            .repeat_interleave(reps, dim=2)
        ctx.save_for_backward(xl, wg)
        # x's layout, not x: a tensor kept on ctx would outlive remat
        ctx.at, ctx.w = at, w.shape
        ctx.x = (mesh, x.placements, x.shape, x.stride())
        placements = [Shard(2) if i == m else p
                      for i, p in enumerate(x.placements)]
        shape = (x.shape[0], x.shape[1], H, w.shape[-1])
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    @staticmethod
    def backward(ctx, g):
        m, first, kv, reps = ctx.at
        xl, wg = ctx.saved_tensors
        mesh, placements, shape, stride = ctx.x
        g = g.redistribute(mesh, [Shard(2) if i == m else p
                                  for i, p in enumerate(placements)])
        gl = g.to_local()
        gg = gl.reshape(gl.shape[:2] + (kv, reps, gl.shape[-1])).sum(3)
        dx = torch.einsum("bshx,dhx->bsd", gg, wg)
        dwg = torch.einsum("bsd,bshx->dhx", xl, gg)
        dw = dwg.new_zeros(ctx.w)
        dw.narrow(1, first, kv).copy_(dwg)
        dx = DTensor.from_local(
            dx, mesh, [Partial() if i == m else p
                       for i, p in enumerate(placements)],
            run_check=False, shape=shape, stride=stride)
        # summed over this rank's tokens (the data axes' shares) and its
        # groups (the model axis's): a partial sum over every mesh dim
        dw = DTensor.from_local(
            dw, mesh, [Partial() if i == m or p.is_shard() else Replicate()
                       for i, p in enumerate(placements)],
            run_check=False, shape=ctx.w, stride=contiguous_stride(ctx.w))
        return dx, dw, None, None


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= max(d, 1)
    return tuple(reversed(stride))


def kv_by_query_heads(x, wk, wv, H: int):
    """``(k, v)``, each ``(B, S, H, hd)``: ``x @ wk`` and ``x @ wv``
    repeated to the query's ``H`` heads and split over the model axis as
    the query is, each rank projecting only its groups' key heads (see
    the module); ``None`` where that layout does not apply (a plain
    tensor, no parallel context, heads the model axis divides, or a batch
    it splits)."""
    at = _groups(x, H, wk.shape[1])
    if at is None or not isinstance(wk, DTensor):
        return None
    return _KVByQueryHeads.apply(x, wk, H, at), \
        _KVByQueryHeads.apply(x, wv, H, at)


def write_slot(cache, write: int, new) -> None:
    """``cache[:, write] = new[:, 0]``, in place: a decode step's K or V
    ``new`` ``(B, 1, KV, hd)`` into its cache ``(B, C, KV, hd)``. On a
    DTensor cache that one mesh dim splits along the slots (the rules'
    cache length over the model axis, where the model axis does not divide
    the KV heads), the rank that holds slot ``write`` writes it into its
    own share and the others write nothing, as GSPMD's
    ``dynamic_update_slice`` of a split dim does; ``new`` is laid out as
    the cache's other dims are (where it comes repeated to the query's
    heads, :func:`kv_by_query_heads`, one copy of each key head).
    DTensor's ``select`` of a split dim gathers the whole cache first."""
    if not isinstance(cache, DTensor):
        cache[:, write] = new[:, 0]
        return
    mesh = cache.device_mesh
    slots = [m for m, p in enumerate(cache.placements)
             if p.is_shard(1) and mesh.size(m) > 1]
    if len(slots) != 1 or any(p.is_partial() for p in cache.placements):
        cache[:, write] = new[:, 0]
        return
    m = slots[0]
    local = cache.to_local()
    lo = mesh.get_coordinate()[m] * local.shape[1]
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    new = new.redistribute(mesh, [Replicate() if i == m else p
                                  for i, p in enumerate(cache.placements)])
    if lo <= write < lo + local.shape[1]:
        heads = new.to_local()[:, 0]
        if new.shape[2] != cache.shape[2]:   # repeated by kv_by_query_heads
            heads = heads[:, ::new.shape[2] // cache.shape[2]]
        local[:, write - lo] = heads


def redistribute_over_data(t, placements):
    """``t.redistribute(mesh, placements)`` where ``t`` moves from a split
    along one dim to a split along another over every data axis (and
    stays as it is over the others): with two data axes ("pod", "data"),
    one all-to-all over their flattened group of ranks, as GSPMD issues
    it, where DTensor runs one a mesh dim. Any other move is DTensor's."""
    ctx = get_parallel_context()
    mesh = t.device_mesh
    data = [mesh.mesh_dim_names.index(a) for a in ctx.data_axes] \
        if ctx is not None and len(ctx.data_axes) > 1 else []
    src = {t.placements[m] for m in data}
    dst = {placements[m] for m in data}
    if not data or len(src) != 1 or len(dst) != 1 or src == dst \
            or not all(p.is_shard() for p in src | dst) \
            or any(t.placements[m] != placements[m]
                   for m in range(mesh.ndim) if m not in data) \
            or any(p.is_partial() for p in t.placements):
        return t.redistribute(mesh, placements)
    flat = mesh[ctx.data_axes]._flatten()
    (a,), (b,) = src, dst
    shape = _flat_shape(t, data, a)
    local = DTensor.from_local(t.to_local(), flat, [a], run_check=False,
                               shape=shape, stride=contiguous_stride(shape)
                               ).redistribute(flat, [b])
    return DTensor.from_local(local.to_local(), mesh, list(placements),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _flat_shape(t, data, a):
    """``t``'s shape as the flattened data group sees it: whole over the
    data axes, split as ``t`` is over the other mesh dims."""
    shape = list(t.to_local().shape)
    n = 1
    for m in data:
        n *= t.device_mesh.size(m)
    shape[a.dim] *= n
    return torch.Size(shape)


def split_as_batch(t, x):
    """``t`` (B, ...), equal in every row (a broadcast ``arange``), laid
    out over the mesh as ``x``'s batch dim is: each rank holds its own rows,
    as GSPMD propagates the batch split into the positions and their
    rotary angles. A plain ``x`` (or a ``t`` already laid out) leaves ``t``
    as it is; DTensor would compute the angles for the whole batch on
    every rank."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    placements = [Shard(0) if p.is_shard(0) else Replicate()
                  for p in x.placements]
    local = t[:x.to_local().shape[0]] if any(
        p.is_shard(0) for p in placements) else t
    return DTensor.from_local(local, x.device_mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


# process-global, as the parallel context is: autograd's device threads
# recompute a layer under remat and must see what its forward saw
_d_split = {"kept": False}


@contextlib.contextmanager
def keep_d_split():
    """An encoder-decoder's layer: its self-attention's output feeds the
    cross-attention's query, which contracts d split over the model axis,
    so GSPMD keeps d split there. The dry run's product layout then keeps
    ``wo``'s output columns split over the model axis where the data axes
    split them too (the heads do not divide it), and moves a step's
    tokens over the data axes, not the weight, where they hold fewer
    bytes than its share (a decode). A plain tensor never reads it."""
    prev = _d_split["kept"]
    _d_split["kept"] = True
    try:
        yield
    finally:
        _d_split["kept"] = prev


def d_split_kept() -> bool:
    """Whether :func:`keep_d_split` is in force."""
    return _d_split["kept"]
