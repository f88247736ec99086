"""Topology layer: links, the :class:`Topology` protocol, and the registry.

The simulator core is topology-agnostic. A concrete topology owns every
:class:`Link` in the fabric and implements routing as "send this packet one
step and schedule its arrival" operations against the simulator facade (which
exposes ``now``, ``rng``, ``maybe_drop`` and the two arrival schedulers).

Implementations:

* ``fat_tree``   — the paper's two-level full-bisection leaf/spine fabric
                   (:class:`repro.core.canary.network.FatTree`).
* ``three_tier`` — a folded-Clos leaf/agg/core fabric
                   (:class:`ThreeTierFatTree`, below) that exercises the
                   load-balancing policies on 4-hop paths.

Registering a new topology::

    @register_topology("my_fabric")
    class MyFabric(Topology):
        ...

and select it with ``SimConfig(topology="my_fabric")`` — no engine, switch or
host-protocol changes needed.
"""
from __future__ import annotations

from collections import deque
from heapq import heappush as _heappush
from typing import Dict, List, Optional, Type

from .engine import EV_LINK_ARRIVE_HOST, EV_LINK_ARRIVE_SWITCH
from .types import Packet, PacketKind, SimConfig

# Dead-link sentinel (repro.core.faults): a downed link is "poisoned" by
# setting ``busy_until`` to this horizon. Everything falls out of the one
# representation: backlog-metric LB policies see an effectively infinite
# queue and route around it, the ECMP/hash fast paths check the already
# loaded ``busy_until`` against the horizon (one float compare, no extra
# memory traffic on fault-free runs), and the shared tx helpers turn sends
# on a poisoned link into charged drops. Finite (not ``inf``) so telemetry
# backlog series stay plottable. Healing simply rewinds ``busy_until`` to
# ``now`` — pre-fault backlog was already drained or dropped.
LINK_DOWN_HORIZON = 1e15


class Link:
    """A unidirectional link with serialization, propagation and a FIFO queue.

    A link keeps ``busy_until`` — the time its output is committed through —
    and the backlog at time ``t`` is ``(busy_until - t) * bytes_per_ns``. This
    gives exact serialization + queueing delay for FIFO ports without per-byte
    events, and is what the adaptive load-balancing policy (§5.2: "up port
    with the smallest number of enqueued bytes") inspects.

    ``inflight`` is the staged-arrival FIFO (ARCHITECTURE.md §Performance):
    ``(arrival_t, seq, packet)`` entries in transmit order. Only the head has
    an event in the engine heap (kind ``EV_LINK_ARRIVE_*``, ``c`` = this
    link); the engine re-arms the next head when it pops. Per-link arrivals
    are monotone in ``(t, seq)``, so staging changes where an entry *waits*,
    never its dispatch order — the golden replays pin this.
    """

    __slots__ = ("busy_until", "bytes_sent", "bytes_per_ns", "latency_ns",
                 "capacity", "inflight")

    def __init__(self, bytes_per_ns: float, latency_ns: float, capacity: int):
        self.busy_until = 0.0
        self.bytes_sent = 0
        self.bytes_per_ns = bytes_per_ns
        self.latency_ns = latency_ns
        self.capacity = capacity
        self.inflight = deque()

    def backlog_bytes(self, now: float) -> float:
        b = (self.busy_until - now) * self.bytes_per_ns
        return b if b > 0.0 else 0.0

    def occupancy(self, now: float) -> float:
        return self.backlog_bytes(now) / self.capacity

    def transmit(self, now: float, size_bytes: int) -> float:
        """Enqueue ``size_bytes`` at ``now``; return arrival time at the far end."""
        start = self.busy_until if self.busy_until > now else now
        self.busy_until = start + size_bytes / self.bytes_per_ns
        self.bytes_sent += size_bytes
        return self.busy_until + self.latency_ns


class Topology:
    """Routing/fabric protocol the simulator layers program against.

    ``sim`` in every signature is the :class:`~.simulator.Simulator` facade;
    topologies use only its ``engine`` (clock + ``push`` scheduler), its
    ``rng``/``cfg`` state, the drop state (``_drop_prob``/``_rng_random``,
    the inlined form of ``maybe_drop()``), the packet ``pool`` and its
    ``dropped`` counter. Stubs driving a topology directly (tests) must
    provide those attributes.
    """

    name: str = ""

    # --- identity ----------------------------------------------------------
    cfg: SimConfig
    L: int                 # number of leaf (host-facing) switches
    num_switches: int
    num_hosts: int

    # Pre-resolved hot-path binding (None until :meth:`bind`): topologies
    # built standalone (tests, shape checks) stay usable for routing/shape
    # queries; driving ``tx_*`` requires a bound facade (or stub).
    _pool_free = None
    # Transport-policy egress hook (repro.core.transport): every tx site
    # calls ``_transport.on_egress(link, pkt, qdelay_ns)`` after serializing
    # — the ECN-marking / PFC-watermark observation point. None (the default
    # ``transport="none"`` policy, and stub sims without the attribute)
    # costs one identity check per send and nothing else.
    _transport = None
    # Telemetry hub (repro.core.telemetry): only consulted inside the rare
    # wire-drop branch, so the common send path pays nothing even when on.
    _telemetry = None

    def bind(self, sim) -> None:
        """Pre-resolve per-run callables (ARCHITECTURE.md §Performance).
        Called once by the :class:`~.simulator.Simulator` facade after all
        layers exist. Subclasses extend this to bind their own hot-path
        state (the engine for inline pushes, the RNG draw)."""
        self._pool_free = sim.pool.free
        self._transport = getattr(sim, "transport", None)
        self._telemetry = getattr(sim, "telemetry", None)

    @classmethod
    def config_num_switches(cls, cfg: SimConfig) -> int:
        """Switch count implied by ``cfg`` without building the fabric.
        Override with a closed-form count; the default builds an instance
        (correct for any topology, but allocates links)."""
        return cls(cfg).num_switches

    def leaf_of(self, host: int) -> int:
        raise NotImplementedError

    def is_leaf(self, sw: int) -> bool:
        raise NotImplementedError

    def is_up_port(self, sw: int, port: int) -> bool:
        """True when ``port`` points away from the hosts (toward the core)."""
        raise NotImplementedError

    # --- flow identity (shared by all fabrics so they never diverge) -------
    def flow_hash(self, pkt: Packet) -> int:
        """Default up-path hash. Same-block partials share the hash and so
        converge on one up-path (maximizing aggregation); different blocks
        spread ("each block in a different root", §3.1.3); a retransmitted
        generation gets a different id and hence a different default path
        (§3.3). Background noise hashes on destination only."""
        kind = pkt.kind
        if kind == PacketKind.NOISE:
            return hash(pkt.dest)
        if kind == PacketKind.RING:
            return hash((pkt.dest, pkt.step))
        return hash((pkt.dest, pkt.id))

    @staticmethod
    def flowlet_key(pkt: Packet) -> tuple:
        """Identity of a point-to-point flowlet [37] (NOISE/RING traffic)."""
        return (int(pkt.kind), pkt.src, pkt.dest,
                pkt.chunk if pkt.kind == PacketKind.NOISE else pkt.step)

    # --- shared transmit + drop accounting ---------------------------------
    # Every link send follows the same sequence: serialize on the link (bytes
    # count even for packets dropped in flight), roll the iid drop, schedule
    # the arrival. Topologies must route through these two helpers so drop
    # semantics can never diverge between fabrics. A packet dropped in flight
    # is at end-of-life: linear (non-multicast) ones go back to the pool.
    def tx_to_switch(self, sim, link: Link, pkt: Packet, sw: int,
                     port: int) -> float:
        eng = sim.engine
        now = eng.now
        bu = link.busy_until
        if bu >= LINK_DOWN_HORIZON:
            # poisoned by a fault schedule (only ever true when sim.faults
            # exists): the send is a charged drop, the link stays poisoned
            sim.faults.on_tx_down(link, pkt, sw)
            return now + pkt.size_bytes / link.bytes_per_ns
        start = bu if bu > now else now
        link.busy_until = busy = start + pkt.size_bytes / link.bytes_per_ns
        link.bytes_sent += pkt.size_bytes
        tp = self._transport
        if tp is not None:
            tp.on_egress(link, pkt, busy - now)
        if sim._drop_prob and sim._rng_random() < sim._drop_prob:
            sim.dropped += 1
            tel = self._telemetry
            if tel is not None:
                tel.on_drop("wire", sw)
            if not pkt.multicast:
                sim.pool.free(pkt)
        else:
            eng._seq = seq = eng._seq + 1
            arrival = busy + link.latency_ns
            q = link.inflight
            q.append((arrival, seq, pkt))
            if len(q) == 1:
                _heappush(eng.heap, (arrival, seq, EV_LINK_ARRIVE_SWITCH,
                                     sw, port, link))
        return busy

    def tx_to_host(self, sim, link: Link, pkt: Packet, host: int) -> float:
        eng = sim.engine
        now = eng.now
        bu = link.busy_until
        if bu >= LINK_DOWN_HORIZON:
            sim.faults.on_tx_down(link, pkt, host)
            return now + pkt.size_bytes / link.bytes_per_ns
        start = bu if bu > now else now
        link.busy_until = busy = start + pkt.size_bytes / link.bytes_per_ns
        link.bytes_sent += pkt.size_bytes
        tp = self._transport
        if tp is not None:
            tp.on_egress(link, pkt, busy - now)
        if sim._drop_prob and sim._rng_random() < sim._drop_prob:
            sim.dropped += 1
            tel = self._telemetry
            if tel is not None:
                tel.on_drop("wire", host)
            if not pkt.multicast:
                sim.pool.free(pkt)
        else:
            eng._seq = seq = eng._seq + 1
            arrival = busy + link.latency_ns
            q = link.inflight
            q.append((arrival, seq, pkt))
            if len(q) == 1:
                _heappush(eng.heap, (arrival, seq, EV_LINK_ARRIVE_HOST,
                                     host, 0, link))
        return busy

    # --- data movement -----------------------------------------------------
    def send_from_host(self, sim, host: int, pkt: Packet) -> float:
        """Transmit on the host NIC; returns the time the NIC frees up."""
        raise NotImplementedError

    def forward_toward_host(self, sim, sw: int, pkt: Packet) -> None:
        """One routing step of a host-destined packet (LB happens here)."""
        raise NotImplementedError

    def forward_toward_switch(self, sim, sw: int, pkt: Packet) -> None:
        """One routing step of a switch-destined (RESTORE) packet."""
        raise NotImplementedError

    def out_port_send(self, sim, sw: int, port: int, pkt: Packet) -> None:
        """Send out an explicit port — broadcast fan-out over recorded children."""
        raise NotImplementedError

    # --- static-tree support ------------------------------------------------
    def root_candidates(self) -> List[int]:
        """Global switch ids eligible as static-tree roots."""
        raise NotImplementedError

    def static_expected(self, parts: List[int], root: int) -> Dict[int, int]:
        """Per-switch child count the static tree rooted at ``root`` waits for."""
        raise NotImplementedError

    def static_send_up(self, sim, sw: int, root: int, pkt: Packet) -> None:
        """Forward a fully-aggregated partial one level toward ``root``."""
        raise NotImplementedError

    # --- fault-injection support -------------------------------------------
    def links_into(self, sw: int) -> List[Link]:
        """Every link whose far end is switch ``sw`` — what a switch-crash
        fault poisons so traffic stops being *offered* to a dead switch
        (packets already in flight still arrive and drop at the failed-switch
        check). Default: no structural knowledge, nothing to poison — crash
        faults on a plug-in fabric then only flush descriptors."""
        return []

    # --- accounting ---------------------------------------------------------
    def all_links(self) -> List[Link]:
        raise NotImplementedError

    def link_names(self) -> List[str]:
        """Human-readable names for ``all_links()``, index-aligned — the
        telemetry hotspot report renders these instead of bare indices.
        Fabrics override with structural names (``leaf3->spine7``); this
        fallback keeps plug-in topologies working unchanged."""
        return [f"link/{i}" for i in range(len(self.all_links()))]

    def utilizations(self, duration_ns: float) -> List[float]:
        if duration_ns <= 0:
            return [0.0 for _ in self.all_links()]
        denom = duration_ns * self.cfg.bytes_per_ns
        return [min(1.0, l.bytes_sent / denom) for l in self.all_links()]


TOPOLOGIES: Dict[str, Type[Topology]] = {}


def register_topology(name: str):
    """Class decorator: make a :class:`Topology` selectable via ``SimConfig``."""

    def deco(cls: Type[Topology]) -> Type[Topology]:
        cls.name = name
        TOPOLOGIES[name] = cls
        return cls

    return deco


def make_topology(cfg: SimConfig) -> Topology:
    try:
        cls = TOPOLOGIES[cfg.topology]
    except KeyError:
        raise ValueError(f"unknown topology {cfg.topology!r}; "
                         f"registered: {sorted(TOPOLOGIES)}") from None
    return cls(cfg)


def pick_min_backlog(links: List[Link], default: int, now: float,
                     policy: str, threshold_bytes: float,
                     remote: Optional[List[Link]] = None) -> int:
    """Generic congestion-aware up-port choice over a candidate link list.

    Mirrors the 2-level ``FatTree.pick_spine`` semantics: ``ecmp`` sticks to
    the hash default; ``adaptive`` keeps the default until its backlog crosses
    the threshold; otherwise (or ``per_packet``) take the least-backlogged
    candidate, ties broken toward the default for determinism. When ``remote``
    is given (one known downstream link per candidate), its backlog joins the
    metric — the CONGA-style path-congestion measure (§2.1).

    Hot path: the metric is computed inline (no per-call closure) and the
    arithmetic is kept bit-identical to ``Link.backlog_bytes`` — backlog is
    ``max(0, busy_until - now) * bytes_per_ns`` per leg, clamped *per link*
    before summing, so the golden replays cannot drift.
    """
    if policy == "ecmp":
        if links[default].busy_until < LINK_DOWN_HORIZON:
            return default
        # hashed member is dead: fall through to the backlog scan, which
        # sees the poisoned link as infinite backlog — the ECMP-group-member
        # removal real switches perform
    link = links[default]
    b = (link.busy_until - now) * link.bytes_per_ns
    best_b = b if b > 0.0 else 0.0
    if remote is not None:
        rl = remote[default]
        b = (rl.busy_until - now) * rl.bytes_per_ns
        if b > 0.0:
            best_b += b
    if policy == "adaptive" and best_b <= threshold_bytes:
        return default
    best = default
    if remote is None:
        for i, link in enumerate(links):
            b = (link.busy_until - now) * link.bytes_per_ns
            if b < 0.0:
                b = 0.0
            if b < best_b - 1e-9:
                best, best_b = i, b
    else:
        for i, link in enumerate(links):
            b = (link.busy_until - now) * link.bytes_per_ns
            if b < 0.0:
                b = 0.0
            rl = remote[i]
            rb = (rl.busy_until - now) * rl.bytes_per_ns
            if rb > 0.0:
                b += rb
            if b < best_b - 1e-9:
                best, best_b = i, b
    return best


@register_topology("three_tier")
class ThreeTierFatTree(Topology):
    """Three-tier folded Clos: hosts — leaves — pod aggregation — core.

    * ``cfg.num_pods`` pods, each with ``num_leaves / num_pods`` leaves and
      ``cfg.aggs_per_pod`` aggregation switches (full bipartite inside the
      pod); ``cfg.num_cores`` core switches, full bipartite to every
      aggregation switch.
    * Global switch ids: leaves ``[0, L)``, aggs ``[L, L+P*A)``, cores
      ``[L+P*A, L+P*A+C)``.
    * Port maps: leaf — ``[0, H)`` hosts then ``[H, H+A)`` pod aggs;
      agg — ``[0, leaves_per_pod)`` pod leaves then cores; core — one port
      per agg (``pod * A + agg_in_pod``).

    Cross-pod paths are 4 switch hops (leaf→agg→core→agg→leaf), so the
    congestion-aware policies make two up-port decisions per packet — this is
    the topology the LB sensitivity sweeps use. Oversubscription falls out of
    the counts (e.g. 8 leaves/pod vs 2 aggs/pod).
    """

    def __init__(self, cfg: SimConfig):
        cfg.validate()
        self.cfg = cfg
        self.L = cfg.num_leaves
        self.H = cfg.hosts_per_leaf
        self.P = cfg.num_pods
        if self.P <= 0 or self.L % self.P:
            raise ValueError("three_tier needs num_pods > 0 dividing num_leaves")
        self.A = cfg.aggs_per_pod
        self.C = cfg.num_cores
        if self.A <= 0 or self.C <= 0:
            raise ValueError("three_tier needs aggs_per_pod and num_cores > 0")
        self.leaves_per_pod = self.L // self.P
        self.num_hosts = cfg.num_hosts
        self.num_aggs = self.P * self.A
        self.num_switches = self.L + self.num_aggs + self.C
        bpn, lat, cap = cfg.bytes_per_ns, cfg.hop_latency_ns, cfg.buffer_bytes

        def mk() -> Link:
            return Link(bpn, lat, cap)

        self.host_up = [mk() for _ in range(self.num_hosts)]
        self.host_down = [mk() for _ in range(self.num_hosts)]
        # leaf <-> agg, within the pod: indexed [leaf][agg_in_pod]
        self.leaf_up = [[mk() for _ in range(self.A)] for _ in range(self.L)]
        self.leaf_down = [[mk() for _ in range(self.A)] for _ in range(self.L)]
        # agg <-> core, full bipartite: indexed [agg_global_local][core]
        self.agg_up = [[mk() for _ in range(self.C)]
                       for _ in range(self.num_aggs)]
        self.agg_down = [[mk() for _ in range(self.C)]
                         for _ in range(self.num_aggs)]
        self.flowlets: dict = {}
        # hot-path LB state, resolved once (ARCHITECTURE.md §Performance)
        self._lb = str(cfg.lb)
        self._noise_lb = str(cfg.noise_lb)
        self._thr = cfg.lb_threshold * cfg.buffer_bytes
        self._flowlet = cfg.flowlet_lb
        self._path_aware = cfg.path_aware_lb

    # ---- identity ----------------------------------------------------------
    @classmethod
    def config_num_switches(cls, cfg: SimConfig) -> int:
        return (cfg.num_leaves + cfg.num_pods * cfg.aggs_per_pod
                + cfg.num_cores)

    def leaf_of(self, host: int) -> int:
        return host // self.H

    def pod_of_leaf(self, leaf: int) -> int:
        return leaf // self.leaves_per_pod

    def is_leaf(self, sw: int) -> bool:
        return sw < self.L

    def is_agg(self, sw: int) -> bool:
        return self.L <= sw < self.L + self.num_aggs

    def agg_local(self, sw: int) -> int:
        return sw - self.L

    def core_local(self, sw: int) -> int:
        return sw - self.L - self.num_aggs

    def agg_gid(self, pod: int, a: int) -> int:
        return self.L + pod * self.A + a

    def core_gid(self, c: int) -> int:
        return self.L + self.num_aggs + c

    def is_up_port(self, sw: int, port: int) -> bool:
        if self.is_leaf(sw):
            return port >= self.H
        if self.is_agg(sw):
            return port >= self.leaves_per_pod
        return False

    # ---- low-level sends ---------------------------------------------------
    def send_from_host(self, sim, host: int, pkt: Packet) -> float:
        return self.tx_to_switch(sim, self.host_up[host], pkt,
                                 self.leaf_of(host), host % self.H)

    def _send_to_host(self, sim, host: int, pkt: Packet) -> None:
        self.tx_to_host(sim, self.host_down[host], pkt, host)

    def _send_leaf_to_agg(self, sim, leaf: int, a: int, pkt: Packet) -> None:
        pod = self.pod_of_leaf(leaf)
        self.tx_to_switch(sim, self.leaf_up[leaf][a], pkt,
                          self.agg_gid(pod, a), leaf % self.leaves_per_pod)

    def _send_agg_to_leaf(self, sim, agg_l: int, leaf: int, pkt: Packet) -> None:
        self.tx_to_switch(sim, self.leaf_down[leaf][agg_l % self.A], pkt,
                          leaf, self.H + agg_l % self.A)

    def _send_agg_to_core(self, sim, agg_l: int, c: int, pkt: Packet) -> None:
        self.tx_to_switch(sim, self.agg_up[agg_l][c], pkt, self.core_gid(c),
                          agg_l)

    def _send_core_to_agg(self, sim, c: int, agg_l: int, pkt: Packet) -> None:
        self.tx_to_switch(sim, self.agg_down[agg_l][c], pkt, self.L + agg_l,
                          self.leaves_per_pod + c)

    # ---- LB decisions ------------------------------------------------------
    def _policy_for(self, pkt: Packet) -> str:
        return self._noise_lb if pkt.kind == PacketKind.NOISE else self._lb

    def _pick(self, sim, sw: int, links: List[Link], default: int,
              pkt: Packet, remote: Optional[List[Link]] = None) -> int:
        """Choose an up-port index among ``links`` (flowlet-sticky for
        point-to-point traffic when ``cfg.flowlet_lb``). ``remote`` carries
        the known downstream leg per candidate for CONGA-style path metrics
        (only passed when ``cfg.path_aware_lb``)."""
        kind = pkt.kind
        policy = self._noise_lb if kind == PacketKind.NOISE else self._lb
        if self._flowlet and (kind == PacketKind.NOISE
                              or kind == PacketKind.RING):
            fkey = (sw,) + self.flowlet_key(pkt)
            cached = self.flowlets.get(fkey)
            if cached is not None:
                if links[cached].busy_until < LINK_DOWN_HORIZON:
                    return cached
                # cached member died mid-run: re-pick and re-pin
            choice = pick_min_backlog(links, default, sim.engine.now, policy,
                                      self._thr, remote)
            self.flowlets[fkey] = choice
            return choice
        return pick_min_backlog(links, default, sim.engine.now, policy,
                                self._thr, remote)

    # ---- routing -----------------------------------------------------------
    def forward_toward_host(self, sim, sw: int, pkt: Packet) -> None:
        # flow_hash is computed lazily per branch: final-hop delivery (the
        # most common case — every packet ends in one) never needs it
        dleaf = self.leaf_of(pkt.dest)
        if self.is_leaf(sw):
            if dleaf == sw:
                self._send_to_host(sim, pkt.dest, pkt)
                return
            fh = self.flow_hash(pkt)
            # path-aware metric: when the destination leaf is in this pod
            # the agg->dest-leaf down leg is known per candidate agg; for
            # cross-pod traffic the remaining legs depend on later hops
            remote = [self.leaf_down[dleaf][a] for a in range(self.A)] \
                if self._path_aware and \
                self.pod_of_leaf(dleaf) == self.pod_of_leaf(sw) else None
            a = self._pick(sim, sw, self.leaf_up[sw], fh % self.A, pkt,
                           remote)
            self._send_leaf_to_agg(sim, sw, a, pkt)
        elif self.is_agg(sw):
            agg_l = self.agg_local(sw)
            pod = agg_l // self.A
            if self.pod_of_leaf(dleaf) == pod:
                self._send_agg_to_leaf(sim, agg_l, dleaf, pkt)
            else:
                fh = self.flow_hash(pkt)
                # the down agg in the destination pod is a deterministic hash
                # choice (see the core branch below), so the core->agg down
                # leg per candidate core is known here: measure it (§2.1)
                dagg = self.pod_of_leaf(dleaf) * self.A + fh % self.A
                remote = [self.agg_down[dagg][c] for c in range(self.C)] \
                    if self._path_aware else None
                c = self._pick(sim, sw, self.agg_up[agg_l], fh % self.C, pkt,
                               remote)
                self._send_agg_to_core(sim, agg_l, c, pkt)
        else:
            c = self.core_local(sw)
            dpod = self.pod_of_leaf(dleaf)
            # deterministic hash choice of the destination pod's agg: same
            # block converges on one down-path, maximizing in-path aggregation
            a = self.flow_hash(pkt) % self.A
            if self.agg_down[dpod * self.A + a][c].busy_until \
                    >= LINK_DOWN_HORIZON:
                # hashed agg is dead/unreachable: deterministic walk to the
                # first live pod agg (same choice for every packet of the
                # block, so convergence on one down-path is preserved)
                for alt in range(self.A):
                    dl = self.agg_down[dpod * self.A + (a + alt) % self.A][c]
                    if dl.busy_until < LINK_DOWN_HORIZON:
                        a = (a + alt) % self.A
                        break
            self._send_core_to_agg(sim, c, dpod * self.A + a, pkt)

    def forward_toward_switch(self, sim, sw: int, pkt: Packet) -> None:
        target = pkt.dest_switch
        fh = hash(target)
        if self.is_leaf(sw):
            pod = self.pod_of_leaf(sw)
            if self.is_agg(target) and self.agg_local(target) // self.A == pod:
                self._send_leaf_to_agg(sim, sw, self.agg_local(target) % self.A,
                                       pkt)
            else:
                self._send_leaf_to_agg(sim, sw, fh % self.A, pkt)
        elif self.is_agg(sw):
            agg_l = self.agg_local(sw)
            pod = agg_l // self.A
            if self.is_leaf(target):
                if self.pod_of_leaf(target) == pod:
                    self._send_agg_to_leaf(sim, agg_l, target, pkt)
                else:
                    self._send_agg_to_core(sim, agg_l, fh % self.C, pkt)
            elif self.is_agg(target):
                if self.agg_local(target) // self.A == pod:
                    # sibling agg: bounce via the pod's first leaf
                    self._send_agg_to_leaf(sim, agg_l,
                                           pod * self.leaves_per_pod, pkt)
                else:
                    self._send_agg_to_core(sim, agg_l, fh % self.C, pkt)
            else:
                self._send_agg_to_core(sim, agg_l, self.core_local(target), pkt)
        else:
            c = self.core_local(sw)
            if self.is_agg(target):
                self._send_core_to_agg(sim, c, self.agg_local(target), pkt)
            else:
                dpod = self.pod_of_leaf(target) if self.is_leaf(target) else 0
                self._send_core_to_agg(sim, c, dpod * self.A + fh % self.A, pkt)

    def out_port_send(self, sim, sw: int, port: int, pkt: Packet) -> None:
        if self.is_leaf(sw):
            if port < self.H:
                self._send_to_host(sim, sw * self.H + port, pkt)
            else:
                self._send_leaf_to_agg(sim, sw, port - self.H, pkt)
        elif self.is_agg(sw):
            agg_l = self.agg_local(sw)
            pod = agg_l // self.A
            if port < self.leaves_per_pod:
                self._send_agg_to_leaf(sim, agg_l,
                                       pod * self.leaves_per_pod + port, pkt)
            else:
                self._send_agg_to_core(sim, agg_l, port - self.leaves_per_pod,
                                       pkt)
        else:
            self._send_core_to_agg(sim, self.core_local(sw), port, pkt)

    # ---- static-tree support ----------------------------------------------
    def root_candidates(self) -> List[int]:
        return [self.core_gid(c) for c in range(self.C)]

    def _designated_agg(self, root: int, pod: int) -> int:
        """The one agg a static tree uses in ``pod`` (deterministic per root,
        spread across roots so multi-tree runs use disjoint up-paths)."""
        return self.agg_gid(pod, (self.core_local(root) + pod) % self.A)

    def static_expected(self, parts: List[int], root: int) -> Dict[int, int]:
        plan: Dict[int, int] = {}
        pods = set()
        leaves_by_pod: Dict[int, set] = {}
        for h in parts:
            leaf = self.leaf_of(h)
            plan[leaf] = plan.get(leaf, 0) + 1
            pod = self.pod_of_leaf(leaf)
            pods.add(pod)
            leaves_by_pod.setdefault(pod, set()).add(leaf)
        for pod, leaves in leaves_by_pod.items():
            plan[self._designated_agg(root, pod)] = len(leaves)
        plan[root] = len(pods)
        return plan

    def static_send_up(self, sim, sw: int, root: int, pkt: Packet) -> None:
        if self.is_leaf(sw):
            agg = self._designated_agg(root, self.pod_of_leaf(sw))
            self._send_leaf_to_agg(sim, sw, self.agg_local(agg) % self.A, pkt)
        else:
            self._send_agg_to_core(sim, self.agg_local(sw),
                                   self.core_local(root), pkt)

    # ---- fault-injection support -------------------------------------------
    def links_into(self, sw: int) -> List[Link]:
        if self.is_leaf(sw):
            return ([self.host_up[h]
                     for h in range(sw * self.H, (sw + 1) * self.H)]
                    + [self.leaf_down[sw][a] for a in range(self.A)])
        if self.is_agg(sw):
            agg_l = self.agg_local(sw)
            pod, a = agg_l // self.A, agg_l % self.A
            first = pod * self.leaves_per_pod
            return ([self.leaf_up[leaf][a]
                     for leaf in range(first, first + self.leaves_per_pod)]
                    + [self.agg_down[agg_l][c] for c in range(self.C)])
        c = self.core_local(sw)
        return [self.agg_up[g][c] for g in range(self.num_aggs)]

    # ---- accounting --------------------------------------------------------
    def all_links(self) -> List[Link]:
        out: List[Link] = []
        out.extend(self.host_up)
        out.extend(self.host_down)
        for row in self.leaf_up:
            out.extend(row)
        for row in self.leaf_down:
            out.extend(row)
        for row in self.agg_up:
            out.extend(row)
        for row in self.agg_down:
            out.extend(row)
        return out

    def link_names(self) -> List[str]:
        out = [f"host{h}->leaf{self.leaf_of(h)}"
               for h in range(self.num_hosts)]
        out += [f"leaf{self.leaf_of(h)}->host{h}"
                for h in range(self.num_hosts)]
        for leaf in range(self.L):
            pod = self.pod_of_leaf(leaf)
            out += [f"leaf{leaf}->agg{pod * self.A + a}"
                    for a in range(self.A)]
        for leaf in range(self.L):
            pod = self.pod_of_leaf(leaf)
            out += [f"agg{pod * self.A + a}->leaf{leaf}"
                    for a in range(self.A)]
        for g in range(self.num_aggs):
            out += [f"agg{g}->core{c}" for c in range(self.C)]
        for g in range(self.num_aggs):
            out += [f"core{c}->agg{g}" for c in range(self.C)]
        return out
