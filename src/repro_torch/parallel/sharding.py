"""Sharding rules (port of ``repro/parallel/sharding.py``): parameter,
batch and decode-cache partition specs.

Policy (MaxText-style FSDP + tensor parallelism):

* ``model`` axis carries tensor parallelism — attention heads, MLP hidden,
  MoE experts, Mamba inner channels, vocab.
* the data axes (``("pod", "data")`` or ``("data",)``) carry batch
  parallelism and FSDP sharding of params + optimizer state.
* every rule is divisibility-guarded: if the preferred dim does not divide
  evenly over the axis the rule falls through to the next candidate (e.g.
  qwen2-7b's 28 heads over a 16-way model axis fall back to sharding
  d_model over data x model), ending at full replication.

The rules read only the mesh's axis sizes: ``mesh`` is a
:class:`DeviceMesh` or a mapping ``{axis name: size}``, so production
shapes can be planned with no process group. They name the port's
per-layer tensors (``layers.3.attn.wq``), where the reference names leaves
stacked over the layers: a port spec is the reference's for the stacked
leaf less its leading ``None``. :func:`param_placements` turns a spec into
``torch.distributed.tensor`` placements on a :class:`DeviceMesh`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

Axes = Union[str, Tuple[str, ...], None]
MeshLike = Union[DeviceMesh, Mapping[str, int]]


class PartitionSpec(tuple):
    """A tensor's partitioning: entry ``d`` is the mesh axis (a name), the
    axes (a tuple of names, outermost first) or ``None`` that dim ``d`` is
    split over; dims past the end are replicated."""

    def __new__(cls, *axes: Axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh: MeshLike) -> Dict[str, int]:
    """``{axis name: size}`` of a :class:`DeviceMesh` or a mapping."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def _t(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axes_size(shape: Mapping[str, int], axes: Axes) -> int:
    n = 1
    for a in _t(axes):
        n *= shape[a]
    return n


def _fits(mesh: MeshLike, shape: Tuple[int, ...], spec: P) -> bool:
    sizes = mesh_shape(mesh)
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        if axes is not None and dim % _axes_size(sizes, axes) != 0:
            return False
    return True


def _first_fit(mesh: MeshLike, shape: Tuple[int, ...], options) -> P:
    for spec in options:
        if _fits(mesh, shape, spec):
            return spec
    return P()


def leaf_spec(name: str, shape: Tuple[int, ...], mesh: MeshLike, fsdp: Axes,
              model: str, use_fsdp: bool = True) -> P:
    """PartitionSpec for one parameter tensor, by its innermost name."""
    f = fsdp if use_fsdp else None
    shape = tuple(shape)
    nd = len(shape)

    def fit(*options) -> P:
        return _first_fit(mesh, shape, options)

    if name == "tok":
        return fit(P(model, f), P(f, model), P(None, model), P())
    if name == "unembed":
        return fit(P(f, model), P(model, f), P(model, None), P())
    if name == "wq":
        return fit(P(f, model, None), P((*_t(f), model), None, None),
                   P(f, None, None), P())
    if name in ("wk", "wv"):
        return fit(P(f, model, None), P(f, None, None), P(model, None, None),
                   P())
    if name == "wo":
        return fit(P(model, None, f), P(None, None, (*_t(f), model)),
                   P(None, None, f), P())
    if name in ("bq", "bk", "bv"):
        return fit(P(model, None), P())
    if name in ("w_up", "w_gate"):
        if nd == 3:  # MoE experts (E, d, f)
            return fit(P(model, f, None), P(None, f, model),
                       P(None, model, None), P())
        return fit(P(f, model), P(model, None), P())
    if name == "w_down":
        if nd == 3:  # MoE experts (E, f, d)
            return fit(P(model, None, f), P(None, model, f),
                       P(None, None, model), P())
        return fit(P(model, f), P(None, model), P())
    if name == "router":
        return P()
    if name == "w_in":
        return fit(P(f, model), P(None, model), P())
    if name == "w_out":
        return fit(P(model, f), P(model, None), P())
    if name == "conv_w":
        return fit(P(None, model), P())
    if name == "conv_b":
        return fit(P(model), P())
    # norms, scalars, A_log, D, dt_bias, norm_scale ...
    return P()


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", leaf))


def param_specs(params: Any, mesh: MeshLike, *, fsdp: Axes = "data",
                model: str = "model", use_fsdp: bool = True
                ) -> Dict[str, P]:
    """``{parameter name: PartitionSpec}`` of an ``nn.Module`` (its
    ``named_parameters``, the meta device will do) or of a mapping from
    dotted names to tensors or shapes."""
    named = params.named_parameters() if hasattr(params, "named_parameters") \
        else params.items()
    return {n: leaf_spec(n.rsplit(".", 1)[-1], _shape_of(t), mesh, fsdp,
                         model, use_fsdp=use_fsdp) for n, t in named}


def param_placements(spec: P, device_mesh: DeviceMesh) -> list:
    """``torch.distributed.tensor`` placements of ``spec``: one a mesh dim,
    ``Shard(d)`` where tensor dim ``d`` is split over that axis, else
    ``Replicate()``. Two axes on one dim (``P(("data", "model"))``) split
    it in mesh-dim order, data-major as the reference's."""
    out = []
    for axis in device_mesh.mesh_dim_names:
        dims = [d for d, axes in enumerate(spec) if axis in _t(axes)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def sharding_constraint(t, spec: P, device_mesh: DeviceMesh):
    """A DTensor ``t`` laid out as ``spec`` (the reference's
    ``with_sharding_constraint``). Where a partial sum is to be split along
    a dim its mesh dim does not divide (the logits over a vocabulary the
    model axis does not divide), it is first reduced whole, in float32 as
    the port's sums over ranks are (:mod:`.regions`), and each rank then
    keeps its share: GSPMD's all-reduce there, where DTensor would
    scatter the padded sum."""
    placements = param_placements(spec, device_mesh)
    if any(p.is_partial() and q.is_shard()
           and t.shape[q.dim] % device_mesh.size(m)
           for m, (p, q) in enumerate(zip(t.placements, placements))):
        t = t.to(torch.float32).redistribute(device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return t.redistribute(device_mesh, placements)


def batch_spec(mesh: MeshLike, global_batch: int, dp_axes: Axes) -> P:
    """Batch sharding: data axes when divisible, else replicate."""
    sizes = mesh_shape(mesh)
    if global_batch % _axes_size(sizes, dp_axes) == 0:
        return P(dp_axes)
    axes = _t(dp_axes)    # fewer of the outer data axes
    for i in range(len(axes) - 1, 0, -1):
        sub = axes[:i]
        if global_batch % _axes_size(sizes, sub) == 0:
            return P(sub)
    return P(None)


def _cache_rule(name: str, shape: Tuple[int, ...], mesh: MeshLike,
                dp_axes: Axes, model: str) -> P:
    nd = len(shape)
    if name in ("k", "v") and nd == 4:        # (B, C, KV, hd)
        return _first_fit(mesh, shape, [P(dp_axes, None, model, None),
                                        P(dp_axes, model, None, None),
                                        P(None, model, None, None),
                                        P(dp_axes, None, None, None), P()])
    if name == "state":                       # (B, H, P, N)
        return _first_fit(mesh, shape, [P(dp_axes, model, None, None),
                                        P(dp_axes, None, None, None),
                                        P(None, model, None, None), P()])
    if name == "conv":                        # (B, K-1, ch)
        return _first_fit(mesh, shape, [P(dp_axes, None, model),
                                        P(dp_axes, None, None),
                                        P(None, None, model), P()])
    if name == "pos":
        return P()
    if nd >= 1:                               # cross-attention caches etc.
        return _first_fit(mesh, shape, [P(dp_axes), P()])
    return P()


def cache_specs(cache: Any, mesh: MeshLike, *, dp_axes: Axes,
                model: str) -> Any:
    """Decode-cache sharding, a tree shaped like ``cache`` (``init_cache``'s
    dicts and per-layer lists): batch over data axes when divisible; KV
    heads over model when divisible, else cache length over model
    (sequence-parallel decode attention for long contexts)."""
    def walk(node, name: str):
        if isinstance(node, Mapping):
            return {k: walk(v, str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        return _cache_rule(name, tuple(getattr(node, "shape", ())), mesh,
                           dp_axes, model)
    return walk(cache, "")
