"""Global parallel context (port of ``repro/parallel/context.py``): which
mesh and axes the model layers use.

Layers stay mesh-agnostic; the launcher installs a context and the layers
consult it: the MoE layer for its expert-parallel forms and, on the dense
path, for the data group it routes over; the train step for the data
groups its gradients are averaged over. When no context is installed
(unit tests, one rank) every layer takes its single-rank path.

The reference's context holds a JAX ``Mesh`` over the devices of one
program; here the mesh is a ``torch.distributed`` :class:`DeviceMesh` over
processes, one a rank, and the context also hands out its process groups.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch.distributed as dist
from torch.distributed import ProcessGroup
from torch.distributed.device_mesh import DeviceMesh


@dataclass(frozen=True)
class ParallelContext:
    mesh: DeviceMesh
    data_axes: Tuple[str, ...]   # batch-parallel axes, e.g. ("pod", "data")
    model_axis: str              # tensor/expert-parallel axis
    # Pin activations to batch-over-data sharding at period boundaries
    # (``models.transformer._activation_constraint``, on DTensors only);
    # False inside the reference's data-manual regions (the explicit
    # grad-sync modes).
    constrain_activations: bool = True
    # False inside the explicit grad-sync modes, whose data-manual
    # shard_map the reference's layers cannot nest in: no expert-parallel
    # form, and the dense MoE path routes this rank's rows alone (True:
    # the whole data group's, as one program over the global batch).
    allow_shardmap_layers: bool = True
    # Sequence parallelism of the boundary activations: the sequence is
    # also split over the model axis there (set by the dry run only).
    sequence_parallel: bool = False

    @property
    def data_spec(self) -> Union[str, Tuple[str, ...]]:
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    def _size(self, axis: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(axis))

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.data_axes:
            n *= self._size(a)
        return n

    @property
    def tp_size(self) -> int:
        return self._size(self.model_axis)

    @property
    def data_groups(self) -> Tuple[ProcessGroup, ...]:
        """One process group a data axis, outermost first: the ranks that
        share this rank's coordinates on every other axis."""
        return tuple(self.mesh.get_group(a) for a in self.data_axes)

    @property
    def model_group(self) -> ProcessGroup:
        return self.mesh.get_group(self.model_axis)

    @property
    def data_index(self) -> int:
        """This rank's data-parallel index, data-major over the data axes
        (the order of the reference's ``P(("pod", "data"))``)."""
        i = 0
        for a in self.data_axes:
            i = i * self._size(a) + self.mesh.get_local_rank(a)
        return i

    @property
    def model_rank(self) -> int:
        return dist.get_rank(self.model_group)


# One context a process, where the reference keeps one a thread: a rank is
# a process, and on the card autograd runs the backward pass, with remat's
# recomputation of each layer's forward, on its own device threads, which
# must see the context the forward saw.
_state: dict = {"ctx": None}


def set_parallel_context(ctx: Optional[ParallelContext]) -> None:
    _state["ctx"] = ctx


def get_parallel_context() -> Optional[ParallelContext]:
    return _state["ctx"]


@contextlib.contextmanager
def parallel_context(ctx: ParallelContext):
    prev = get_parallel_context()
    set_parallel_context(ctx)
    try:
        yield ctx
    finally:
        set_parallel_context(prev)
