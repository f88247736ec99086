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
* :func:`heads_over_idle_data`: a decode's product of the probabilities
  and the values spread by query heads over data axes that leave the
  batch whole;
* :func:`on_local_heads`: a decode's attention on each rank's own batch
  rows and heads, where the mesh splits nothing else;
* :func:`columns_over_idle_data`, :func:`over_model` and
  :func:`on_split_heads`: a Mamba-2 decode of one sequence, its input
  projection's columns over the idle data axes, its state by heads over
  the model axis and its product with C on each rank's heads;
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


def _data_dims(t) -> Optional[Tuple[list, int, int]]:
    """``(dims, n, r)``: the mesh dims of more than one rank that the
    parallel context names data axes, their ranks ``n`` and this rank's
    place ``r`` among them (flattened in mesh order, as consecutive
    ``Shard`` placements of one dim split it); ``None`` without a context
    or data dims, or where a data dim splits ``t``."""
    ctx = get_parallel_context()
    if ctx is None or not isinstance(t, DTensor):
        return None
    mesh = t.device_mesh
    names = mesh.mesh_dim_names or ()
    dims = [m for m, a in enumerate(names)
            if a in ctx.data_axes and mesh.size(m) > 1]
    if not dims or any(not t.placements[m].is_replicate() for m in dims):
        return None
    n, r = 1, 0
    for m in dims:
        n *= mesh.size(m)
        r = r * mesh.size(m) + mesh.get_coordinate()[m]
    return dims, n, r


def heads_over_idle_data(probs, v, like):
    """``_gqa_out(probs, v)`` (probs ``(B, KV, G, Sq, C)``, v ``(B, C, KV,
    D)``) where the data axes leave the batch whole (a decode of one
    sequence, ``long_500k``'s): each data rank multiplies the
    probabilities of its share of the ``KV * G`` query heads (flattened,
    consecutive) against their key heads' values, as GSPMD spreads the
    product over the idle data ranks, where DTensor runs every head on
    each of them. The output ``(B, Sq, H, D)`` comes laid out as the query
    ``like`` is over the mesh dims that do not split the batch (its heads
    over the model axis, where the output projection contracts them): the
    partial sums over the cache's slots reduced, each data rank's heads
    moved to the ranks that hold them. ``None`` on a
    plain tensor, where a data axis splits the batch, or where a rank's
    heads neither fall in one group nor make whole groups."""
    at = _data_dims(probs)
    if at is None or _data_dims(v) is None \
            or probs.device_mesh != v.device_mesh:
        return None
    dims, n, r = at
    mesh = probs.device_mesh
    B, KV, G, Sq, _ = probs.shape
    D = v.shape[-1]
    share = KV * G // n
    if (KV * G) % n or (G % share and share % G):
        return None
    placements = []
    for m, (pp, pv) in enumerate(zip(probs.placements, v.placements)):
        if m in dims:
            placements.append(Shard(2))
        elif mesh.size(m) == 1 or pp.is_replicate() and pv.is_replicate():
            placements.append(Replicate())
        elif pp.is_shard(4) and pv.is_shard(1):
            placements.append(Partial())    # the slots' split: summed
        else:
            return None
    pl, vl = probs.to_local(), v.to_local()
    first = r * share
    if share <= G:          # one key head: its values against the heads
        kv, g = divmod(first, G)
        out = torch.einsum("bhqs,bsd->bqhd", pl[:, kv, g:g + share],
                           vl[:, :, kv])
    else:                   # whole groups
        kv, k = first // G, share // G
        out = torch.einsum("bkgqs,bskd->bqkgd", pl[:, kv:kv + k],
                           vl[:, :, kv:kv + k]).reshape(B, Sq, share, D)
    shape = (B, Sq, KV * G, D)
    out = DTensor.from_local(out, mesh, placements, run_check=False,
                             shape=torch.Size(shape),
                             stride=contiguous_stride(shape))
    want = [Replicate() if m in dims or p.is_partial() else p
            for m, p in enumerate(like.placements)] \
        if isinstance(like, DTensor) and like.device_mesh == mesh \
        else [Replicate()] * mesh.ndim
    return out.redistribute(mesh, want)


def on_local_heads(fn, q, k, v):
    """``fn(q, k, v)`` (a decode's attention: q ``(B, Sq, H, D)``, k and v
    ``(B, S, KV, D)``) on each rank's local tensors, where every mesh dim
    splits the three alike along the batch, or splits q's heads and k's
    and v's key heads evenly, or leaves them whole: each rank's block of
    the output is then its own (B, H) block's attention, as GSPMD leaves
    it in place. DTensor merges the split batch and key-head dims into
    one batch of the product, which torch 2.13 splits in its strided way
    and torch 2.11 gathers over the model axis (the whole cache, 1 GiB a
    layer of a 32768-slot MoE decode). The output is laid out as q;
    ``None`` on a plain tensor or any other layout."""
    if not all(isinstance(t, DTensor) for t in (q, k, v)) \
            or not q.device_mesh == k.device_mesh == v.device_mesh:
        return None
    mesh = q.device_mesh
    for m, (pq, pk, pv) in enumerate(zip(q.placements, k.placements,
                                         v.placements)):
        if mesh.size(m) == 1 or pq == pk == pv == Replicate() \
                or pq == pk == pv == Shard(0):
            continue
        n = mesh.size(m)
        if not (pq == pk == pv == Shard(2) and q.shape[2] % n == 0
                and k.shape[2] % n == 0):
            return None
    if any(type(p) not in (Shard, Replicate)
           for t in (q, k, v) for p in t.placements):
        return None
    out = fn(q.to_local(), k.to_local(), v.to_local())
    return DTensor.from_local(out, mesh, q.placements, run_check=False,
                              shape=q.shape, stride=q.stride())


def columns_over_idle_data(x, w):
    """``x @ w`` where the data axes leave x's batch and ``w`` whole (a
    decode of one sequence): each data rank multiplies its share of
    ``w``'s columns, as GSPMD spreads the product over the idle data
    ranks, and the columns are gathered after (a partial sum over the
    other dims reduced with them). DTensor would multiply every column on
    each data rank. The plain product elsewhere."""
    at = _data_dims(x)
    if at is None or _data_dims(w) is None \
            or x.device_mesh != w.device_mesh:
        return x @ w
    mesh, dims = x.device_mesh, at[0]
    out = x @ w.redistribute(mesh, [Shard(1) if m in dims else p
                                    for m, p in enumerate(w.placements)])
    return out.redistribute(mesh, [Replicate() if m in dims or p.is_partial()
                                   else p for m, p in enumerate(
                                       out.placements)])


def over_model(t, placement):
    """``t`` laid out as ``placement`` over the model axis where the data
    axes leave its batch whole (a Mamba-2 decode of one sequence): its
    state split by heads, torch.chunk's share of them where the model axis
    does not divide them (2 of 24 heads on the first 12 of 16 ranks, as
    GSPMD pads them), and the conv's output whole for the products with
    B and C; DTensor would split the state along N as the conv's channels
    split B and C. ``t`` as it is elsewhere."""
    ctx = get_parallel_context()
    if _data_dims(t) is None \
            or ctx.model_axis not in t.device_mesh.mesh_dim_names:
        return t
    mesh = t.device_mesh
    m = mesh.mesh_dim_names.index(ctx.model_axis)
    return t.redistribute(mesh, [placement if i == m else p
                                 for i, p in enumerate(t.placements)])


def on_split_heads(fn, t, *whole):
    """``fn(t, *whole)``, a product that keeps ``t``'s dims 0 and 1 (the
    batch, the heads), on each rank's own block of ``t`` where the mesh
    splits ``t`` by heads at most and leaves every ``whole`` operand
    replicated; the output comes split as ``t``. DTensor would gather
    heads that the model axis splits unevenly (a Mamba-2 decode's 24 on 16
    ranks) to flatten them for the product. ``None`` on a plain tensor or
    any other layout."""
    if not isinstance(t, DTensor) \
            or any(not (p.is_replicate() or p == Shard(1))
                   for p in t.placements) \
            or any(not isinstance(w, DTensor) or w.device_mesh
                   != t.device_mesh or any(not p.is_replicate()
                                           for p in w.placements)
                   for w in whole):
        return None
    out = fn(t.to_local(), *(w.to_local() for w in whole))
    shape = t.shape[:2] + out.shape[2:]
    return DTensor.from_local(out, t.device_mesh, t.placements,
                              run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


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
