"""Parallelism: the parallel context the layers consult, and the sharding
rules (port of ``repro/parallel``)."""
from .context import (ParallelContext, get_parallel_context,
                      parallel_context, set_parallel_context)
from .sharding import (P, PartitionSpec, batch_spec, cache_specs, leaf_spec,
                       mesh_shape, param_placements, param_specs,
                       sharding_constraint)

__all__ = ["P", "ParallelContext", "PartitionSpec", "batch_spec",
           "cache_specs", "get_parallel_context", "leaf_spec", "mesh_shape",
           "param_placements", "param_specs", "parallel_context",
           "set_parallel_context", "sharding_constraint"]
