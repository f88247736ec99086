"""The device collective (port of ``repro/core/collective``): multi-root
binomial-tree allreduce over a ``torch.distributed`` process group, with the
congestion oracle that plans each block's root (a copy of the reference's
numpy-only ``congestion.py``)."""
from .api import canary_allreduce_tree, fixed_point_scales
from .congestion import CongestionOracle, round_robin_roots, tree_link_load
from .trees import (hierarchical_allreduce, multi_root_tree_allreduce,
                    ring_allreduce, tree_reduce_broadcast)

__all__ = ["CongestionOracle", "canary_allreduce_tree",
           "fixed_point_scales", "hierarchical_allreduce",
           "multi_root_tree_allreduce", "ring_allreduce", "round_robin_roots",
           "tree_link_load", "tree_reduce_broadcast"]
