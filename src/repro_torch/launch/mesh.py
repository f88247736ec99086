"""Meshes over ranks, and hardware constants for one card's roofline.

``make_host_mesh`` builds the ``("data", "model")`` :class:`DeviceMesh`
that the training launcher runs under; ``make_production_mesh`` the
reference's production shapes, (16, 16) over ``("data", "model")`` and
(2, 16, 16) over ``("pod", "data", "model")``. ``pod`` and ``data`` both
carry batch parallelism (and FSDP), ``model`` carries tensor, expert and
sequence parallelism. Ranks are laid out row-major, as ``jax.make_mesh``
lays out devices: rank ``d * model + m`` sits at ``(d, m)``. Each is a
function (never a module-level constant), so importing this module starts
no process group; every rank of the default group must call it.

The constants are the NVIDIA H100 SXM5's, from NVIDIA's H100 Tensor Core
GPU datasheet, and ``LINK_BW`` the DGX H100's network. The workload
compiler's ``HostSpec`` (:mod:`repro_torch.core.workload.timeline`) takes
its defaults from here, ``chip_smoke.py`` its bounds, and the dry run
(:mod:`.dryrun`) its roofline terms.
"""
from __future__ import annotations

from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..parallel.sharding import MeshLike, mesh_shape

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh; the world must have its size."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over every rank of the default process group."""
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_axes(mesh: MeshLike) -> Tuple[Tuple[str, ...], str]:
    """(data axes, model axis) for a production-shaped mesh."""
    if "pod" in mesh_shape(mesh):
        return ("pod", "data"), "model"
    return ("data",), "model"


# Hardware constants for the roofline (NVIDIA H100 SXM5)
PEAK_FLOPS_BF16 = 989e12      # per card, dense bf16 tensor-core peak
HBM_BW = 3.35e12              # bytes/s per card (HBM3)
# Bytes/s a card sends to a card outside its node: one 400 Gb/s NDR
# InfiniBand port a card (a DGX H100 has one ConnectX-7 a GPU; NVIDIA DGX
# H100 user guide). Both production axes leave an 8-card NVLink domain: the
# model axis's 16 consecutive ranks span two nodes, and the data axis
# strides across nodes. The collective term of the dry run divides by it
# (the reference's ``ICI_BW``). NVLink 4 gives 450e9 bytes/s a direction
# inside a node; no production axis stays inside one, so it is not used.
LINK_BW = 50e9
