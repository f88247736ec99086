"""Workload layer: background congestion traffic and sender-side noise.

The paper's evaluation (§5.2) surrounds the allreduce with two disturbance
models, both of which live here rather than in the host protocol:

* **Random-uniform congestion** — every non-participant "noise host" streams
  ``noise_msg_bytes``-sized messages to uniformly re-drawn noise-host peers.
  The background jobs and the allreduce are distinct applications: noise
  flows target noise hosts, sharing the fabric (leaf/spine links) with the
  allreduce but not the participants' NICs.
* **Sender OS noise (§5.2.5)** — with probability ``noise_prob`` a host's
  next send is delayed by ``noise_delay_ns``, emulating jittery sender
  stacks.

Both consume the simulator's single RNG stream, so runs stay reproducible.

Hot-path note (ARCHITECTURE.md §Performance): noise generation is *batched*
per message — the one RNG peer draw still happens exactly when the first
packet of a message is pumped (so the RNG stream and event order are
bit-identical to per-packet generation), but all of the message's packets are
materialized into a per-host buffer in one pass and handed out by ``pop`` on
subsequent pumps. The buffer is consulted at the same priority point as
before (after protocol sends, never ahead of them).
"""
from __future__ import annotations

from typing import List, Optional

from .types import Packet, PacketKind


class CongestionWorkload:
    """Background-traffic generation + sender-noise decisions."""

    def __init__(self, sim, noise_hosts: Optional[List[int]]):
        self.sim = sim
        self.noise_hosts = list(noise_hosts or [])
        self._noise_set = set(self.noise_hosts)
        cfg = sim.cfg
        self._noise_prob = cfg.noise_prob
        self._noise_delay = cfg.noise_delay_ns
        self._msg_bytes = cfg.noise_msg_bytes
        self._payload = cfg.payload_bytes
        self._header = cfg.header_bytes
        self._rng = sim.rng

    def start(self) -> None:
        """Kick every noise host's pump at t=0 (after job setup)."""
        for h in self.noise_hosts:
            self.sim.hostproto.schedule_pump(h, 0.0)

    def next_noise_packet(self, host: int, hs) -> Optional[Packet]:
        """The next background-traffic packet for ``host`` (None when the
        host is not a noise host). ``hs`` is the host's ``_HostState``; its
        ``noise_buf`` holds the rest of the current message, pre-built."""
        buf = hs.noise_buf
        if buf:
            return buf.pop()
        if host not in self._noise_set:
            return None
        hosts = self.noise_hosts
        n = len(hosts)
        if n < 2:
            return None  # a lone noise host has no peer to stream to
        # random-uniform pattern *among the congestion hosts* (§5.2) — the
        # draw happens at the first packet of each message, exactly as in
        # per-packet generation
        rng = self._rng
        peer = hosts[rng.randrange(n)]
        while peer == host:
            peer = hosts[rng.randrange(n)]
        hs.noise_peer = peer
        hs.noise_msg_idx = idx = hs.noise_msg_idx + 1
        # batch-build the whole message, last packet first so buf.pop()
        # yields packets in transmission order
        payload = self._payload
        header = self._header
        remaining = self._msg_bytes
        alloc = self.sim.pool.alloc
        if remaining <= 0:
            # degenerate config: header-only packet per pump, like the old
            # per-packet generator (peer redrawn every call)
            pkt = alloc()
            pkt.kind = PacketKind.NOISE
            pkt.dest = peer
            pkt.id = 0
            pkt.size_bytes = header
            pkt.src = host
            pkt.chunk = idx
            hs.noise_remaining = 0
            return pkt
        first: Optional[Packet] = None
        while remaining > 0:
            take = payload if remaining >= payload else remaining
            remaining -= take
            pkt = alloc()
            pkt.kind = PacketKind.NOISE
            pkt.dest = peer
            pkt.id = 0
            pkt.size_bytes = take + header
            pkt.src = host
            pkt.chunk = idx
            if first is None:
                first = pkt
            else:
                buf.append(pkt)
        buf.reverse()
        hs.noise_remaining = 0
        return first

    def sender_delay_ns(self, host: int) -> Optional[float]:
        """§5.2.5 sender-side OS noise: delay the pending send or not."""
        if self._noise_prob > 0.0 and self._rng.random() < self._noise_prob:
            return self._noise_delay
        return None
