"""Two-level fat-tree network model (§5.2) — the paper's topology.

Topology (paper defaults): 32 leaf switches with 64 ports each (32 down to
hosts, 32 up — one to each spine), 32 spine switches with 32 ports (one per
leaf). 100 Gb/s everywhere, 300 ns per hop.

This is the ``fat_tree`` implementation of the :class:`~.topology.Topology`
protocol (see ``topology.py`` for the protocol and the registry, and
``ARCHITECTURE.md`` for the layer map). Routing — including the
congestion-aware up-port selection the paper assumes as its substrate (§2.1)
— lives here; the switch dataplane and host protocol layers never touch a
link directly.

Node addressing
---------------
* hosts:   ``0 .. num_hosts-1``; host ``h`` hangs off leaf ``h // hosts_per_leaf``.
* switches (global index): leaves ``0 .. L-1``, spines ``L .. L+S-1``.

Port numbering (matches the children-bitmap semantics of §4.2)
---------------------------------------------------------------
* leaf ``l``:  port ``p < hosts_per_leaf``  -> host ``l*hosts_per_leaf + p`` (down)
               port ``hosts_per_leaf + s``  -> spine ``s``                  (up)
* spine ``s``: port ``l``                   -> leaf ``l``                   (down)
"""
from __future__ import annotations

import random
from heapq import heappush as _heappush
from typing import Dict, List, Optional

from .engine import EV_LINK_ARRIVE_HOST, EV_LINK_ARRIVE_SWITCH
from .topology import (LINK_DOWN_HORIZON, Link, Topology, pick_min_backlog,
                       register_topology)
from .types import Packet, PacketKind, SimConfig

__all__ = ["FatTree", "Link"]

_K_NOISE = int(PacketKind.NOISE)
_K_RING = int(PacketKind.RING)
_EV_SW = EV_LINK_ARRIVE_SWITCH  # staged-arrival kinds used by the inline tx
_EV_HOST = EV_LINK_ARRIVE_HOST


@register_topology("fat_tree")
class FatTree(Topology):
    """Topology + routing. Switch indices are global (leaves then spines)."""

    def __init__(self, cfg: SimConfig):
        cfg.validate()
        self.cfg = cfg
        self.L = cfg.num_leaves
        self.S = cfg.num_spines
        self.H = cfg.hosts_per_leaf
        self.num_hosts = cfg.num_hosts
        self.num_switches = self.L + self.S
        bpn, lat, cap = cfg.bytes_per_ns, cfg.hop_latency_ns, cfg.buffer_bytes

        def mk() -> Link:
            return Link(bpn, lat, cap)

        # host <-> leaf
        self.host_up = [mk() for _ in range(cfg.num_hosts)]    # host -> leaf
        self.host_down = [mk() for _ in range(cfg.num_hosts)]  # leaf -> host
        # leaf <-> spine (full bipartite)
        self.leaf_up = [[mk() for _ in range(self.S)] for _ in range(self.L)]
        self.leaf_down = [[mk() for _ in range(self.S)] for _ in range(self.L)]
        # flowlet tables: (leaf, flow key) -> committed spine [37]
        self.flowlets: dict = {}
        # hot-path LB/routing state, resolved once per fabric build
        # (ARCHITECTURE.md §Performance): policy strings, the adaptive
        # threshold in bytes, and per-host leaf/port maps as flat tuples.
        self._lb = str(cfg.lb)
        self._noise_lb = str(cfg.noise_lb)
        self._thr = cfg.lb_threshold * cfg.buffer_bytes
        self._flowlet = cfg.flowlet_lb
        self._path_aware = cfg.path_aware_lb
        self._dp = cfg.drop_prob
        # policy fast-path codes: 0 = ecmp (hash default, no metric),
        # 1 = adaptive (default while under threshold), 2 = full scan
        _codes = {"ecmp": 0, "adaptive": 1}
        self._lb_code = _codes.get(self._lb, 2)
        self._noise_code = _codes.get(self._noise_lb, 2)
        self._host_leaf = tuple(h // self.H for h in range(cfg.num_hosts))
        # bound in bind() (facade wiring): the engine (for inline event
        # pushes), its RNG draw, and the packet pool
        self._engine = None
        self._rngr = None

    def bind(self, sim) -> None:
        super().bind(sim)
        self._engine = sim.engine
        self._rngr = sim.rng.random

    # ---- helpers -----------------------------------------------------------
    @classmethod
    def config_num_switches(cls, cfg: SimConfig) -> int:
        return cfg.num_leaves + cfg.num_spines

    def leaf_of(self, host: int) -> int:
        return host // self.H

    def is_leaf(self, sw: int) -> bool:
        return sw < self.L

    def spine_index(self, sw: int) -> int:
        return sw - self.L

    def is_up_port(self, sw: int, port: int) -> bool:
        return self.is_leaf(sw) and port >= self.H

    # Port maps (see module docstring).
    def leaf_port_of_host(self, host: int) -> int:
        return host % self.H

    def leaf_port_of_spine(self, spine: int) -> int:
        return self.H + spine

    def spine_port_of_leaf(self, leaf: int) -> int:
        return leaf

    # ---- LB: pick the up-port (spine) for a packet leaving ``leaf`` --------
    def pick_spine(self, leaf: int, now: float, flow_hash: int,
                   rng: Optional[random.Random] = None,
                   dest_leaf: int = -1, policy: Optional[str] = None) -> int:
        """Congestion-aware up-port selection (§2.1, §5.2).

        The paper's premise is an existing congestion-aware load-balancing
        substrate (CONGA [37], DRILL [41], ...). CONGA-style schemes measure
        *path* congestion, so when the destination leaf is known the metric
        is the up-link backlog **plus** the spine->dest-leaf down-link
        backlog (the ``remote`` leg); purely local schemes would leave
        destination-side hotspots invisible. The policy arithmetic itself is
        the shared :func:`~.topology.pick_min_backlog`, so the two fabrics
        can never drift apart.
        """
        default = flow_hash % self.S
        lb = str(policy) if policy is not None else self._lb
        remote = self.leaf_down[dest_leaf] \
            if self._path_aware and dest_leaf >= 0 and dest_leaf != leaf \
            else None
        return pick_min_backlog(self.leaf_up[leaf], default, now, lb,
                                self._thr, remote)

    # NOTE: flowlet-sticky decisions live inline in forward_toward_host (the
    # only consumer), keyed by the flat (leaf, kind, src, dest, chunk/step)
    # shape — any second entry point must share that key shape or the same
    # flowlet could commit to two different spines.

    # ---- transmit ----------------------------------------------------------
    # The hot sends below deliberately replicate the Topology.tx_to_switch /
    # tx_to_host sequence inline (serialize -> iid drop -> schedule arrival,
    # dropped linear packets recycled) with the engine pre-bound — this is
    # the innermost packet loop of the whole repo. The canonical semantics
    # live in Topology.tx_*; the golden replays pin the equivalence.
    def send_from_host(self, sim, host: int, pkt: Packet) -> float:
        link = self.host_up[host]
        eng = self._engine
        now = eng.now
        bu = link.busy_until
        if bu >= LINK_DOWN_HORIZON:  # poisoned by a fault (topology.py)
            sim.faults.on_tx_down(link, pkt, self._host_leaf[host])
            return now + pkt.size_bytes / link.bytes_per_ns
        start = bu if bu > now else now
        link.busy_until = busy = start + pkt.size_bytes / link.bytes_per_ns
        link.bytes_sent += pkt.size_bytes
        tp = self._transport
        if tp is not None:
            tp.on_egress(link, pkt, busy - now)
        if self._dp and self._rngr() < self._dp:
            sim.dropped += 1
            if not pkt.multicast:
                self._pool_free(pkt)
        else:
            eng._seq = seq = eng._seq + 1
            arrival = busy + link.latency_ns
            q = link.inflight
            q.append((arrival, seq, pkt))
            if len(q) == 1:
                _heappush(eng.heap, (arrival, seq, _EV_SW,
                                     self._host_leaf[host], host % self.H,
                                     link))
        return busy

    def _send_leaf_up(self, sim, leaf: int, spine: int, pkt: Packet) -> None:
        self.tx_to_switch(sim, self.leaf_up[leaf][spine], pkt, self.L + spine,
                          self.spine_port_of_leaf(leaf))

    def _send_spine_down(self, sim, spine: int, leaf: int, pkt: Packet) -> None:
        self.tx_to_switch(sim, self.leaf_down[leaf][spine], pkt, leaf,
                          self.leaf_port_of_spine(spine))

    def _send_leaf_to_host(self, sim, host: int, pkt: Packet) -> None:
        self.tx_to_host(sim, self.host_down[host], pkt, host)

    # ---- routing -----------------------------------------------------------
    def forward_toward_host(self, sim, sw: int, pkt: Packet) -> None:
        dest = pkt.dest
        H = self.H
        dleaf = dest // H
        eng = self._engine
        size = pkt.size_bytes
        if sw >= self.L:                         # spine: one hop down
            link = self.leaf_down[dleaf][sw - self.L]
            now = eng.now
            bu = link.busy_until
            if bu >= LINK_DOWN_HORIZON:
                sim.faults.on_tx_down(link, pkt, dleaf)
                return
            start = bu if bu > now else now
            link.busy_until = busy = start + size / link.bytes_per_ns
            link.bytes_sent += size
            tp = self._transport
            if tp is not None:
                tp.on_egress(link, pkt, busy - now)
            if self._dp and self._rngr() < self._dp:
                sim.dropped += 1
                if not pkt.multicast:
                    self._pool_free(pkt)
            else:
                eng._seq = seq = eng._seq + 1
                arrival = busy + link.latency_ns
                q = link.inflight
                q.append((arrival, seq, pkt))
                if len(q) == 1:
                    _heappush(eng.heap, (arrival, seq, _EV_SW, dleaf,
                                         H + sw - self.L, link))
            return
        if dleaf == sw:                          # leaf: deliver to the host
            link = self.host_down[dest]
            now = eng.now
            bu = link.busy_until
            if bu >= LINK_DOWN_HORIZON:
                sim.faults.on_tx_down(link, pkt, dest)
                return
            start = bu if bu > now else now
            link.busy_until = busy = start + size / link.bytes_per_ns
            link.bytes_sent += size
            tp = self._transport
            if tp is not None:
                tp.on_egress(link, pkt, busy - now)
            if self._dp and self._rngr() < self._dp:
                sim.dropped += 1
                if not pkt.multicast:
                    self._pool_free(pkt)
            else:
                eng._seq = seq = eng._seq + 1
                arrival = busy + link.latency_ns
                q = link.inflight
                q.append((arrival, seq, pkt))
                if len(q) == 1:
                    _heappush(eng.heap, (arrival, seq, _EV_HOST, dest, 0,
                                         link))
            return
        # Default up-port: Topology.flow_hash — same-block partials converge
        # on one spine, blocks spread, retransmitted generations re-route
        # (§3.1.3/§3.3). Background congestion rides its own policy (§2.1);
        # with flowlet_lb the seed monolith dropped that policy — passing it
        # is an intentional (non-golden-covered) behaviour fix that keeps
        # noise_lb semantics identical across fabrics.
        kind = pkt.kind
        if kind == _K_NOISE:
            fh = hash(dest)
            policy = self._noise_lb
            code = self._noise_code
        elif kind == _K_RING:
            fh = hash((dest, pkt.step))
            policy = self._lb
            code = self._lb_code
        else:
            fh = hash((dest, pkt.id))
            policy = self._lb
            code = self._lb_code
        if self._flowlet and (kind == _K_NOISE or kind == _K_RING):
            # point-to-point traffic moves at flowlet granularity [37].
            # Flat inline form of (sw, flowlet_key(pkt)) — this fabric's
            # flowlet cache is only ever keyed here, so the shape is private.
            key = (sw, kind, pkt.src, dest,
                   pkt.chunk if kind == _K_NOISE else pkt.step)
            spine = self.flowlets.get(key)
            if spine is None or \
                    self.leaf_up[sw][spine].busy_until >= LINK_DOWN_HORIZON:
                # no commitment yet, or the committed spine died mid-run:
                # (re-)pick and (re-)pin
                remote = self.leaf_down[dleaf] \
                    if self._path_aware and dleaf >= 0 else None
                spine = pick_min_backlog(self.leaf_up[sw], fh % self.S,
                                         eng.now, policy, self._thr, remote)
                self.flowlets[key] = spine
        elif code == 0:  # ecmp: the hash default, no metric
            spine = fh % self.S
            if self.leaf_up[sw][spine].busy_until >= LINK_DOWN_HORIZON:
                # dead ECMP member: the backlog scan sees the poisoned link
                # as infinite backlog and routes around it
                spine = pick_min_backlog(self.leaf_up[sw], spine, eng.now,
                                         policy, self._thr, None)
        else:
            # inline the pick_min_backlog fast path: adaptive stays on the
            # default while its (per-leg clamped) path backlog is under the
            # threshold; anything else falls through to the full scan
            spine = -1
            links = self.leaf_up[sw]
            default = fh % self.S
            now = eng.now
            remote = self.leaf_down[dleaf] \
                if self._path_aware and dleaf >= 0 else None
            if code == 1:
                l0 = links[default]
                m = (l0.busy_until - now) * l0.bytes_per_ns
                if m < 0.0:
                    m = 0.0
                if remote is not None:
                    r0 = remote[default]
                    rb = (r0.busy_until - now) * r0.bytes_per_ns
                    if rb > 0.0:
                        m += rb
                if m <= self._thr:
                    spine = default
            if spine < 0:
                spine = pick_min_backlog(links, default, now, policy,
                                         self._thr, remote)
        link = self.leaf_up[sw][spine]
        now = eng.now
        bu = link.busy_until
        if bu >= LINK_DOWN_HORIZON:
            # every LB path above avoids dead members where an alternative
            # exists; reaching here means the whole group is down
            sim.faults.on_tx_down(link, pkt, self.L + spine)
            return
        start = bu if bu > now else now
        link.busy_until = busy = start + size / link.bytes_per_ns
        link.bytes_sent += size
        tp = self._transport
        if tp is not None:
            tp.on_egress(link, pkt, busy - now)
        if self._dp and self._rngr() < self._dp:
            sim.dropped += 1
            if not pkt.multicast:
                self._pool_free(pkt)
        else:
            eng._seq = seq = eng._seq + 1
            arrival = busy + link.latency_ns
            q = link.inflight
            q.append((arrival, seq, pkt))
            if len(q) == 1:
                _heappush(eng.heap, (arrival, seq, _EV_SW, self.L + spine,
                                     sw, link))

    def forward_toward_switch(self, sim, sw: int, pkt: Packet) -> None:
        target = pkt.dest_switch
        if self.is_leaf(sw):
            if self.is_leaf(target):
                fh = hash(target)
                spine = self.pick_spine(sw, sim.now, fh, sim.rng,
                                        dest_leaf=target)
                self._send_leaf_up(sim, sw, spine, pkt)
            else:
                self._send_leaf_up(sim, sw, self.spine_index(target), pkt)
        else:
            if self.is_leaf(target):
                self._send_spine_down(sim, self.spine_index(sw), target, pkt)
            else:
                # spine -> spine requires bouncing off any leaf; route via leaf 0
                self._send_spine_down(sim, self.spine_index(sw), 0, pkt)

    def out_port_send(self, sim, sw: int, port: int, pkt: Packet) -> None:
        # broadcast fan-out hot path: resolve the link, then the same inline
        # tx sequence as above (see the transmit section note)
        H = self.H
        if sw < self.L:
            if port < H:
                host = sw * H + port
                link = self.host_down[host]
                ev_kind, a, b = _EV_HOST, host, 0
            else:
                spine = port - H
                link = self.leaf_up[sw][spine]
                ev_kind, a, b = _EV_SW, self.L + spine, sw
        else:
            link = self.leaf_down[port][sw - self.L]
            ev_kind, a, b = _EV_SW, port, H + sw - self.L
        eng = self._engine
        now = eng.now
        bu = link.busy_until
        size = pkt.size_bytes
        if bu >= LINK_DOWN_HORIZON:
            sim.faults.on_tx_down(link, pkt, a)
            return
        start = bu if bu > now else now
        link.busy_until = busy = start + size / link.bytes_per_ns
        link.bytes_sent += size
        tp = self._transport
        if tp is not None:
            tp.on_egress(link, pkt, busy - now)
        if self._dp and self._rngr() < self._dp:
            sim.dropped += 1
            if not pkt.multicast:
                self._pool_free(pkt)
        else:
            eng._seq = seq = eng._seq + 1
            arrival = busy + link.latency_ns
            q = link.inflight
            q.append((arrival, seq, pkt))
            if len(q) == 1:
                _heappush(eng.heap, (arrival, seq, ev_kind, a, b, link))

    # ---- static-tree support ----------------------------------------------
    def root_candidates(self) -> List[int]:
        return [self.L + s for s in range(self.S)]

    def static_expected(self, parts: List[int], root: int) -> Dict[int, int]:
        plan: Dict[int, int] = {}
        for h in parts:
            leaf = self.leaf_of(h)
            plan[leaf] = plan.get(leaf, 0) + 1
        plan[root] = len(plan)
        return plan

    def static_send_up(self, sim, sw: int, root: int, pkt: Packet) -> None:
        self._send_leaf_up(sim, sw, self.spine_index(root), pkt)

    # ---- fault-injection support --------------------------------------------
    def links_into(self, sw: int) -> List[Link]:
        if sw < self.L:
            return ([self.host_up[h]
                     for h in range(sw * self.H, (sw + 1) * self.H)]
                    + [self.leaf_down[sw][s] for s in range(self.S)])
        s = sw - self.L
        return [self.leaf_up[leaf][s] for leaf in range(self.L)]

    # ---- utilization accounting ---------------------------------------------
    def all_links(self) -> List[Link]:
        out: List[Link] = []
        out.extend(self.host_up)
        out.extend(self.host_down)
        for row in self.leaf_up:
            out.extend(row)
        for row in self.leaf_down:
            out.extend(row)
        return out

    def link_names(self) -> List[str]:
        out = [f"host{h}->leaf{h // self.H}" for h in range(self.num_hosts)]
        out += [f"leaf{h // self.H}->host{h}" for h in range(self.num_hosts)]
        for leaf in range(self.L):
            out += [f"leaf{leaf}->spine{s}" for s in range(self.S)]
        for leaf in range(self.L):
            out += [f"spine{s}->leaf{leaf}" for s in range(self.S)]
        return out
