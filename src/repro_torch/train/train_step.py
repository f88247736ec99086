"""Training step factory with pluggable gradient synchronization (port of
``repro/train/train_step.py``).

``grad_sync`` strategies:

* ``auto``          — plain autograd. On one rank nothing is synchronised;
                      across ranks the gradients are averaged with an
                      all-reduce (the reference leaves this to GSPMD).
* ``canary``        — the paper's technique: this rank's gradients are
                      reduced explicitly with blockwise multi-root dynamic
                      trees (``canary_allreduce_tree``).
* ``ring``          — explicit bandwidth-optimal reduce-scatter/all-gather
                      (the paper's host-based baseline).
* ``hierarchical``  — pod-local reduce-scatter, cross-pod exchange,
                      pod-local all-gather (two-level meshes).
* ``canary_fp``     — canary + fixed-point (int32) blocks: bit-reproducible
                      sums regardless of tree shape, through the port's
                      quantize and dequantize kernels, with one scale a
                      leaf of the reference's stacked pytree (the port's
                      per-layer tensors grouped by
                      :func:`repro_torch.convert.reference_leaves`), so the
                      int32 sums are the reference's.

The reference runs one program over a JAX ``Mesh`` and slices the batch
with ``shard_map``; here every rank is a process, the :class:`Mesh` holds
the data-parallel process groups, and each rank is handed its data rank's
slice of the global batch (``batch_at(..., batch_slice=Mesh.batch_slice)``;
the model ranks of one data rank get the same rows). Under a
:class:`~repro_torch.parallel.ParallelContext` the mesh is its data groups
(:meth:`Mesh.of`): the gradients are averaged, and the Canary trees run,
over data ranks only, since every model rank ends its backward pass with
the whole gradient. The reference's sharding constraint on the logits
applies where the logits are a DTensor (the dry run's trace over a mesh):
they are redistributed to its layout; one rank's own logits are left as
they are.

Parameters are an ``nn.Module``; a step writes the updated parameters and
moments into its tensors (see :func:`repro_torch.optim.update`).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed import ProcessGroup
from torch.distributed.tensor import DTensor

from ..convert import reference_leaves
from ..core.collective import canary_allreduce_tree
from ..models import forward, init_params
from ..models.config import ModelConfig
from ..optim import AdamWConfig, AdamWState
from ..optim import init as adamw_init
from ..optim import update as adamw_update
from ..parallel import (P, ParallelContext, get_parallel_context,
                        parallel_context, sharding_constraint)
from .losses import cross_entropy

EXPLICIT_MODES = ("canary", "ring", "hierarchical", "canary_fp")
Grads = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    optimizer: AdamWConfig = AdamWConfig()
    grad_sync: str = "auto"
    canary_blocks: int = 16
    canary_roots: Optional[Tuple[int, ...]] = None  # congestion-oracle plan
    z_loss: float = 0.0
    # gradient accumulation: split the global batch into k microbatches and
    # loop over them — activation memory scales with B/k (§Perf lever)
    microbatches: int = 1


@dataclass(frozen=True)
class Mesh:
    """The data-parallel mesh: ``inner`` is the tree axis (intra-pod),
    ``outer`` the optional cross-pod axis. A rank's data-parallel index is
    ``outer rank * inner size + inner rank``, the order of the reference's
    ``P(("pod", "data"))``."""

    inner: ProcessGroup
    outer: Optional[ProcessGroup] = None

    @classmethod
    def of(cls, ctx: ParallelContext) -> "Mesh":
        """The data groups of ``ctx``: the innermost data axis is the tree
        axis, an outer one (``pod``) the cross-pod axis."""
        groups = ctx.data_groups
        return cls(inner=groups[-1],
                   outer=groups[0] if len(groups) > 1 else None)

    @property
    def inner_size(self) -> int:
        return dist.get_world_size(self.inner)

    @property
    def outer_size(self) -> int:
        return 1 if self.outer is None else dist.get_world_size(self.outer)

    @property
    def size(self) -> int:
        return self.inner_size * self.outer_size

    @property
    def groups(self):
        return (self.inner,) if self.outer is None else (self.inner,
                                                        self.outer)

    @property
    def index(self) -> int:
        outer = 0 if self.outer is None else dist.get_rank(self.outer)
        return outer * self.inner_size + dist.get_rank(self.inner)

    def batch_slice(self, global_batch: int) -> Tuple[int, int]:
        """Rows ``[lo, hi)`` of the global batch that this rank trains on."""
        if global_batch % self.size:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {self.size} data-parallel ranks")
        per = global_batch // self.size
        return self.index * per, (self.index + 1) * per

    def mean(self, values: Dict[str, torch.Tensor], first=()
             ) -> Dict[str, torch.Tensor]:
        """``pmean`` over the inner, then the outer group, of 0-d float32
        tensors, in one all-reduce per group; the keys in ``first`` take
        data rank 0's value instead."""
        keys = list(values)
        # a DTensor metric (a trace over a model mesh) whole on every rank
        vec = torch.stack([(v.full_tensor() if isinstance(v, DTensor) else v)
                           .to(torch.float32)
                           for v in (values[k] for k in keys)])
        own = torch.tensor([k in first for k in keys], device=vec.device)
        vec = torch.where(own & (self.index != 0), 0.0, vec)
        for g in self.groups:
            dist.all_reduce(vec, group=g)
            vec = torch.where(own, vec, vec / dist.get_world_size(g))
        return dict(zip(keys, vec.unbind()))


def make_mesh(outer_size: int = 1) -> Mesh:
    """A :class:`Mesh` over every rank of the default process group:
    ``outer_size`` pods of ``world / outer_size`` ranks each. Every rank
    must call it, in the same order as any other group creation."""
    world = dist.get_world_size()
    if world % outer_size:
        raise ValueError(f"{world} ranks do not split into {outer_size} pods")
    if outer_size == 1:
        return Mesh(inner=dist.group.WORLD)
    inner_size, rank = world // outer_size, dist.get_rank()
    inner = outer = None
    for o in range(outer_size):              # every rank creates every group
        g = dist.new_group([o * inner_size + i for i in range(inner_size)])
        if rank // inner_size == o:
            inner = g
    for i in range(inner_size):
        g = dist.new_group([o * inner_size + i for o in range(outer_size)])
        if rank % inner_size == i:
            outer = g
    return Mesh(inner=inner, outer=outer)


def value_and_grad(loss_fn: Callable, params: torch.nn.Module, batch
                   ) -> Tuple[Tuple[torch.Tensor, Dict[str, torch.Tensor]],
                              Grads]:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, batch)``: the
    loss and metrics (detached) and ``{parameter name: gradient}``. Turns
    gradients on for every parameter of ``params``."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            dict(zip(named, grads)))


def make_loss_fn(tc: TrainConfig, constrain: str = "full") -> Callable:
    """``constrain``: 'full' (batch over the data axes, vocab over the model
    axis), 'model' (vocab only) or 'none': the layout the (B, S, V) logits
    are redistributed to when they are a DTensor under a parallel context
    (reference ``train_step.py:59-81``)."""
    if constrain not in ("full", "model", "none"):
        raise ValueError(f"unknown constrain {constrain!r}")
    cfg = tc.model

    def loss_fn(params, batch):
        ctx = get_parallel_context()
        kwargs = {}
        if "frames" in batch:
            kwargs["frames"] = batch["frames"]
        if "patches" in batch:
            kwargs["extra_embeds"] = batch["patches"]
        logits, aux = forward(params, batch["tokens"], cfg, **kwargs)
        if ctx is not None and constrain != "none" \
                and isinstance(logits, DTensor):
            spec = P(ctx.data_spec, None, ctx.model_axis) \
                if constrain == "full" else P(None, None, ctx.model_axis)
            logits = sharding_constraint(logits, spec, ctx.mesh)
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:   # VLM prefix: score text only
            logits = logits[:, logits.shape[1] - labels.shape[1]:]
        loss, metrics = cross_entropy(logits, labels, z_loss=tc.z_loss)
        total = loss + cfg.moe_aux_coef * aux
        metrics["aux_loss"] = aux
        return total, metrics

    return loss_fn


def _microbatched(loss_fn, params, batch, k: int):
    """Gradients of ``k`` microbatches summed in float32, divided by ``k``
    and cast to each parameter's dtype; metrics averaged."""
    named = dict(params.named_parameters())
    g_acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in named.items()}
    m_acc = None
    for i in range(k):
        one = {key: v.reshape((k, v.shape[0] // k) + v.shape[1:])[i]
               for key, v in batch.items()}
        (_, metrics), grads = value_and_grad(loss_fn, params, one)
        for n, g in grads.items():
            g_acc[n] += g.to(torch.float32)
        if m_acc is None:
            m_acc = {key: torch.zeros((), dtype=torch.float32,
                                      device=m.device)
                     for key, m in metrics.items()}
        m_acc = {key: m_acc[key] + metrics[key] / k for key in m_acc}
    grads = {n: (g / k).to(named[n].dtype) for n, g in g_acc.items()}
    return m_acc, grads


def _on_local(grads: Grads, sync: Callable[[Grads], Grads]) -> Grads:
    """``sync`` over the gradients' local tensors: a DTensor gradient (the
    dry run's model-sharded parameters) goes through as this rank's shard,
    over its data groups, and comes back with its placements. ``grads``
    gives its tensors up to ``sync``, as ``canary_allreduce_tree`` takes
    them (it is left empty)."""
    if not any(isinstance(g, DTensor) for g in grads.values()):
        return sync(grads)
    layouts = {n: (g.device_mesh, g.placements, g.shape, g.stride())
               for n, g in grads.items() if isinstance(g, DTensor)}
    local = {n: g.to_local() if isinstance(g, DTensor) else g
             for n, g in grads.items()}
    grads.clear()
    out = sync(local)
    return {n: DTensor.from_local(y, *layouts[n][:2], run_check=False,
                                  shape=layouts[n][2], stride=layouts[n][3])
            if n in layouts else y for n, y in out.items()}


def make_train_step(tc: TrainConfig, mesh: Optional[Mesh] = None,
                    on_sync: Optional[Callable[[Grads, Grads], None]] = None
                    ) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, ``batch`` being this rank's slice. ``on_sync(raw, synced)``,
    if given, sees an explicit mode's gradients before and after the
    collective, before they are averaged and applied (a check of the sync
    against its own input); the sums are then divided in place, so it
    copies what it keeps.

    The step reads the parallel context when it runs. In ``auto`` the MoE
    layers take the reference's forms under it, and the reported
    ``aux_loss`` is data rank 0's, as the reference's expert-parallel
    ``shard_map`` reports its first data shard's (the dense path's global
    aux is the same on every rank). The explicit modes run the backward
    pass per data rank, as the reference's data-manual ``shard_map`` does:
    no activation constraint and no expert-parallel form inside it."""
    loss_fn = make_loss_fn(tc, constrain="full" if tc.grad_sync == "auto"
                           else "none")

    if tc.grad_sync == "auto":
        def train_step(params, opt_state, batch):
            k = tc.microbatches
            if k <= 1:
                (_, metrics), grads = value_and_grad(loss_fn, params, batch)
            else:
                metrics, grads = _microbatched(loss_fn, params, batch, k)
            if mesh is not None and mesh.size > 1:
                grads = canary_allreduce_tree(
                    grads, group=mesh.inner, axis_size=mesh.inner_size,
                    mode="psum", outer_group=mesh.outer)
                for g in grads.values():    # the sums: divided in place
                    g.div_(mesh.size)
                metrics = mesh.mean(metrics, first=(
                    "aux_loss",) if get_parallel_context() else ())
            params, opt_state, om = adamw_update(grads, opt_state, params,
                                                 tc.optimizer)
            metrics.update(om)
            return params, opt_state, metrics
        return train_step

    if tc.grad_sync not in EXPLICIT_MODES:
        raise ValueError(f"unknown grad_sync {tc.grad_sync}")
    if mesh is None:
        raise ValueError("explicit grad_sync modes need a mesh")
    mode = {"canary": "canary", "canary_fp": "canary", "ring": "ring",
            "hierarchical": "hierarchical"}[tc.grad_sync]
    fixed_point = tc.grad_sync == "canary_fp"
    roots = list(tc.canary_roots) if tc.canary_roots is not None else None
    # one fixed-point scale a reference leaf: the layers it stacks share it
    groups = [leaf.names for leaf in reference_leaves(tc.model)] \
        if fixed_point else None

    def train_step(params, opt_state, batch):
        ctx = get_parallel_context()
        if ctx is not None:     # per data rank: no EP form, no data gather
            ctx = replace(ctx, constrain_activations=False,
                          allow_shardmap_layers=False)
        with parallel_context(ctx):
            (_, metrics), grads = value_and_grad(loss_fn, params, batch)
        def sync(local):
            return canary_allreduce_tree(
                local, group=mesh.inner, axis_size=mesh.inner_size,
                roots=roots, num_blocks=tc.canary_blocks, mode=mode,
                outer_group=mesh.outer, fixed_point=fixed_point,
                groups=groups)
        # the sync frees each raw gradient as soon as its synced tensor
        # exists, unless on_sync keeps them for its check
        synced = _on_local(grads if on_sync is None else dict(grads), sync)
        if on_sync is not None:
            on_sync(grads, synced)
        del grads
        if mesh.size > 1:    # average over the data parallelism degree
            for g in synced.values():
                g.div_(mesh.size)
        metrics = mesh.mean(metrics)
        params, opt_state, om = adamw_update(synced, opt_state, params,
                                             tc.optimizer)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step


def init_train_state(tc: TrainConfig, generator: torch.Generator,
                     device=None) -> Tuple[Any, AdamWState]:
    """Random parameters (``init_params``) with gradients on, and zero AdamW
    moments. ``device=None`` means CUDA."""
    params = init_params(tc.model, generator, device=device)
    params.requires_grad_(True)
    return params, adamw_init(params, tc.optimizer)
