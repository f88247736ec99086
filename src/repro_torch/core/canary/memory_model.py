"""Switch memory occupancy model (§3.2.2).

A block descriptor lives from the arrival of the block's first packet until
the broadcast sweep deallocates it: ``2 d (l + t) + r`` where ``d`` is the
network diameter, ``l`` the 1-hop delay, ``t`` the aggregation timeout and
``r`` the leader-side processing time. By Little's law, with MTU-sized packets
injected at bandwidth ``b`` the descriptor bytes per switch are::

    (b / m) * (2 d (l + t) + r) * m  =  b * (2 d (l + t) + r)

independent of both the reduced-data size and the number of hosts. The
paper's example (100 Gb/s, d=5, l=300 ns, t=1 us, r=1 us) gives ~175 KiB.
"""
from __future__ import annotations

from dataclasses import dataclass

from .types import SimConfig


@dataclass(frozen=True)
class OccupancyModel:
    bandwidth_gbps: float = 100.0
    diameter: int = 5
    hop_latency_ns: float = 300.0
    timeout_ns: float = 1000.0
    leader_ns: float = 1000.0

    @property
    def descriptor_lifetime_ns(self) -> float:
        return 2 * self.diameter * (self.hop_latency_ns + self.timeout_ns) \
            + self.leader_ns

    @property
    def occupancy_bytes(self) -> float:
        bytes_per_ns = self.bandwidth_gbps / 8.0
        return bytes_per_ns * self.descriptor_lifetime_ns

    @property
    def occupancy_kib(self) -> float:
        return self.occupancy_bytes / 1024.0


def paper_example() -> OccupancyModel:
    """§3.2.2's worked example: ≈175 KiB per switch per allreduce."""
    return OccupancyModel()


def model_for(cfg: SimConfig, diameter: int = 2) -> OccupancyModel:
    """Occupancy model matching a simulator configuration.

    A two-level fat tree has diameter 2 (host->leaf->spine->leaf->host is
    4 hops but the *switch* depth relevant to descriptor lifetime is 2-3);
    callers may override.
    """
    return OccupancyModel(
        bandwidth_gbps=cfg.link_gbps,
        diameter=diameter,
        hop_latency_ns=cfg.hop_latency_ns,
        timeout_ns=cfg.timeout_ns,
        leader_ns=cfg.leader_aggregate_ns,
    )
