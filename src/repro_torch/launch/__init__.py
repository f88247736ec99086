"""Launchers: mesh construction (:mod:`.mesh`), the serving CLI (``python -m
repro_torch.launch.serve``) and the training CLI (``python -m
repro_torch.launch.train``)."""
from .mesh import make_host_mesh, make_production_mesh, mesh_axes

__all__ = ["make_host_mesh", "make_production_mesh", "mesh_axes"]
