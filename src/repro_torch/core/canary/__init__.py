"""The packet-level Canary simulator, copied from the reference package.

The modules here are the reference's jax-free simulator layers (``engine``,
``topology``, ``network``, ``switch``, ``hostproto``, ``workloads``,
``types``) behind the :class:`Simulator` facade, unchanged apart from the
relative imports and the facade refusing the layers not copied yet
(transport, telemetry, faults, fleet admission).
"""
from .simulator import Simulator
from .types import Algo, AllreduceJob, SimConfig, SimResult, scaled_config

__all__ = ["Algo", "AllreduceJob", "SimConfig", "SimResult", "Simulator",
           "scaled_config"]
