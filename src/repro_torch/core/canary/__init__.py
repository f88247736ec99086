"""The packet-level Canary simulator, copied from the reference package.

The modules here are the reference's jax-free simulator layers (``engine``,
``topology``, ``network``, ``switch``, ``hostproto``, ``workloads``,
``types``, ``memory_model``, ``multicast``), the experiment drivers
(``algorithms``) and the backend registry (``backends``) behind the
:class:`Simulator` facade, unchanged apart from relative imports. The
registry's ``"flow"`` entry builds the port's flow backend, which solves on
the card.
"""
from .algorithms import ExperimentResult, compare_algorithms, run_allreduce
from .backends import (BACKENDS, Backend, PacketBackend, get_backend,
                       register_backend, run_cells)
from .engine import EventLoop
from .hostproto import HostProtocol, RingStrategy
from .memory_model import OccupancyModel, model_for, paper_example
from .network import FatTree
from .simulator import Simulator, contribution
from .switch import (ALGORITHMS, AggregationStrategy, CanaryStrategy,
                     StaticTreeStrategy, SwitchLayer, make_strategy,
                     register_algorithm)
from .topology import (TOPOLOGIES, Link, ThreeTierFatTree, Topology,
                       make_topology, register_topology)
from .types import (PAPER_SCALES, Algo, AllreduceJob, Descriptor,
                    LoadBalancing, Packet, PacketKind, SimConfig, SimResult,
                    TenantSpec, block_key, id_app, id_block, id_gen, make_id,
                    paper_config, paper_scale_config, scaled_config,
                    three_tier_config)
from .workloads import CongestionWorkload

__all__ = [
    "ALGORITHMS", "Algo", "AllreduceJob", "AggregationStrategy",
    "BACKENDS", "Backend", "CanaryStrategy", "CongestionWorkload",
    "Descriptor", "EventLoop", "ExperimentResult", "FatTree", "HostProtocol",
    "Link", "LoadBalancing", "OccupancyModel", "PAPER_SCALES", "Packet",
    "PacketBackend", "PacketKind", "RingStrategy", "SimConfig", "SimResult",
    "Simulator", "StaticTreeStrategy", "SwitchLayer", "TOPOLOGIES",
    "TenantSpec", "ThreeTierFatTree", "Topology", "block_key",
    "compare_algorithms", "contribution", "get_backend", "id_app",
    "id_block", "id_gen", "make_id", "make_strategy", "make_topology",
    "model_for", "paper_example", "paper_config", "paper_scale_config",
    "register_algorithm", "register_backend", "register_topology",
    "run_allreduce", "run_cells", "scaled_config", "three_tier_config",
]
