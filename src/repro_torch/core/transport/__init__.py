"""Pluggable transport policies for the packet-level simulator.

String-keyed registry mirroring the algorithm (``switch.ALGORITHMS``),
topology (``topology.TOPOLOGIES``) and backend (``backends.BACKENDS``)
registries. Built-ins:

* ``none``  — the default. Resolved to ``None`` (not an object): every hook
  site in the canary layers short-circuits on one identity check and the
  golden replays stay bit-identical.
* ``gbn``   — go-back-N loss recovery (per-flow sequence numbers, cumulative
  ACKs, block-level re-request flows). See :mod:`.gbn`.
* ``dcqcn`` — RED/ECN marking at egress queues, CNP notification, the DCQCN
  rate-control state machine pacing the host pump, and PFC priority pause.
  See :mod:`.dcqcn`.

Registering a policy::

    from repro_torch.core.transport import register_transport
    from repro_torch.core.transport.base import TransportPolicy

    @register_transport("my_policy")
    class MyPolicy(TransportPolicy):
        ...

then run with ``SimConfig(transport="my_policy")``. This package imports
only the jax-free canary core (the subprocess import test pins that).
"""
from __future__ import annotations

from typing import Dict, Optional, Type

from .base import TX_ABSORBED, TX_PAUSED, TransportPolicy

__all__ = ["TRANSPORTS", "register_transport", "make_transport",
           "TransportPolicy", "TX_PAUSED", "TX_ABSORBED"]

TRANSPORTS: Dict[str, Type[TransportPolicy]] = {}


def register_transport(name: str):
    """Class decorator: bind a policy class to its registry key."""

    def deco(cls: Type[TransportPolicy]) -> Type[TransportPolicy]:
        cls.name = name
        TRANSPORTS[name] = cls
        return cls

    return deco


def make_transport(name, sim) -> Optional[TransportPolicy]:
    """Instantiate the policy registered under ``name`` (``"none"`` ->
    ``None``, the hook-free fast path)."""
    key = str(name)
    if key == "none":
        return None
    try:
        cls = TRANSPORTS[key]
    except KeyError:
        raise ValueError(
            f"no transport policy registered under {name!r}; registered: "
            f"{['none'] + sorted(TRANSPORTS)}") from None
    return cls(sim)


from . import dcqcn as _dcqcn  # noqa: E402,F401  (registers "dcqcn")
from . import gbn as _gbn      # noqa: E402,F401  (registers "gbn")
