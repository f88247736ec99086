"""Switch dataplane layer: per-switch soft state + aggregation strategies.

Two pieces live here (see ``ARCHITECTURE.md``):

* :class:`SwitchLayer` — the algorithm-independent dataplane every switch
  runs: failure state, descriptor tables, arrival dispatch (pass-through
  kinds, RESTORE routing, timer guards), and the tree-restoration fan-out.
* The **algorithm-strategy registry**: :class:`AggregationStrategy`
  subclasses implement how REDUCE/BCAST packets are processed in-network and
  how hosts generate their sends. ``CANARY`` and ``STATIC_TREE`` live here;
  host-based algorithms (``RING``, in ``hostproto.py``) register in the same
  registry and simply leave the switch hooks at their pass-through defaults.

Registering a new collective::

    @register_algorithm(Algo.MY_ALGO)
    class MyStrategy(AggregationStrategy):
        ...

No engine, topology or facade changes are needed — the facade looks the
algorithm up by ``Algo`` value at construction time.

Hot-path notes (ARCHITECTURE.md §Performance): ``SwitchLayer.finalize``
pre-resolves the strategy's dataplane hooks and the topology's forwarding
methods into instance attributes once per run, arrival dispatch branches on
the raw packet-kind int, and descriptor timers use *lazy cancellation* — a
``live_timers`` registry maps an armed timer's sequence number to its
descriptor; firing early or deallocating unregisters the timer, and the
stale ``EV_TIMER`` heap entry is skipped with a single failed dict lookup
when it pops (it still counts as a dispatched event, preserving the golden
``events`` counts). Strategies recycle consumed REDUCE packets through
``sim.pool`` — a packet merged into a descriptor is at end-of-life; anything
forwarded on (stragglers, collisions, bypass) stays live.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Type

from .engine import EV_RETX, EV_TIMER
from .types import (APP_SHIFT, Algo, BLOCK_MASK, Descriptor, GEN_BITS, Packet,
                    PacketKind, id_app)

# kinds the switch dataplane never inspects — pure forwarding
_PASSTHROUGH = (PacketKind.NOISE, PacketKind.RING, PacketKind.RETX_REQ,
                PacketKind.FAIL, PacketKind.UNICAST_DATA)
_K_REDUCE = int(PacketKind.REDUCE)
_K_BCAST = int(PacketKind.BCAST)
_K_RESTORE = int(PacketKind.RESTORE)
_K_RETX_REQ = int(PacketKind.RETX_REQ)  # first of the passthrough id range


class SwitchLayer:
    """Algorithm-independent per-switch state + arrival dispatch."""

    def __init__(self, sim, num_switches: int):
        self.sim = sim
        self.tables: List[Dict[int, Descriptor]] = [dict() for _ in
                                                    range(num_switches)]
        self.slots: List[Dict[int, int]] = [dict() for _ in range(num_switches)]
        self.failed = [False] * num_switches
        self.desc_high = [0] * num_switches
        self.timer_seq = 0
        # lazy timer cancellation: timer_seq -> armed Descriptor. Entries are
        # removed when the descriptor fires (early or by timeout) or is
        # deallocated; a stale EV_TIMER pop then misses here and is dropped.
        self.live_timers: Dict[int, Descriptor] = {}
        # pre-resolved in finalize() once the strategy exists
        self._on_reduce = None
        self._on_bcast = None
        self._fwd_host = None
        self._fwd_switch = None
        self._pool_free = None
        self._telemetry = None

    def finalize(self) -> None:
        """Pre-resolve per-run hot-path callables (strategy hooks + topology
        forwarding). Called by the facade after every layer is built."""
        sim = self.sim
        self._on_reduce = sim.strategy.on_switch_reduce
        self._on_bcast = sim.strategy.on_switch_bcast
        self._fwd_host = sim.net.forward_toward_host
        self._fwd_switch = sim.net.forward_toward_switch
        self._pool_free = sim.pool.free
        self._telemetry = sim.telemetry

    # ------------------------------------------------------------- dispatch
    def arrive(self, sw: int, in_port: int, pkt: Packet) -> None:
        sim = self.sim
        if self.failed[sw]:
            sim.dropped += 1
            sim.dropped_failed += 1
            tel = self._telemetry
            if tel is not None:
                tel.on_drop("switch_fail", sw)
            if not pkt.multicast:
                self._pool_free(pkt)
            return
        kind = pkt.kind
        if kind >= _K_RETX_REQ:
            # _PASSTHROUGH kinds (RETX_REQ..ACK, a contiguous id range:
            # one compare for the most common arrivals): pure forwarding —
            # transport control packets (CNP/ACK) ride this branch too
            self._fwd_host(sim, sw, pkt)
        elif kind == _K_REDUCE:
            self._on_reduce(sw, in_port, pkt)
        elif kind == _K_BCAST:
            self._on_bcast(sw, pkt)
        else:  # RESTORE
            if pkt.dest_switch == sw:
                self.restore_at(sw, pkt)
                self._pool_free(pkt)
            else:
                self._fwd_switch(sim, sw, pkt)

    def on_timer(self, sw: int, timer_seq: int, pid: int) -> None:
        # lazy cancellation: a cancelled/fired timer is a single missed
        # dict lookup here (the heap entry was left in place)
        desc = self.live_timers.pop(timer_seq, None)
        if desc is not None and not self.failed[sw]:
            self.sim.strategy.on_descriptor_timeout(sw, desc)

    def fail_switch(self, sw: int) -> None:
        self.failed[sw] = True

    def crash_switch(self, sw: int) -> None:
        """Mid-run crash (repro.core.faults): mark failed AND flush the
        dataplane — descriptor table, slot map and armed timers all vanish
        with the switch's SRAM. Partials the descriptors were accumulating
        are state, not packets in flight, so nothing is charged to the drop
        counters here; the *protocol* recovers the data (timeout at the
        parent or whole-block retransmission). ``fail_switch`` above is the
        legacy pre-scheduled form and keeps its flush-free semantics — the
        ``canary_switch_failure`` golden pins it."""
        self.failed[sw] = True
        table = self.tables[sw]
        if table:
            for desc in table.values():
                if desc.timer_seq:
                    self.live_timers.pop(desc.timer_seq, None)
            table.clear()
        self.slots[sw].clear()

    def heal_switch(self, sw: int) -> None:
        """Recovery: the switch rejoins with empty tables (crash flushed
        them) and starts admitting descriptors again."""
        self.failed[sw] = False

    # ------------------------------------------------------------- helpers
    # (descriptor high-water tracking is inlined at the two allocation sites
    # in the strategies: ``if len(table) > desc_high[sw]: ...``)
    def dealloc(self, sw: int, desc: Descriptor) -> None:
        self.tables[sw].pop(desc.id, None)
        slots = self.slots[sw]
        if slots.get(desc.slot) == desc.id:
            del slots[desc.slot]
        if desc.timer_seq:
            self.live_timers.pop(desc.timer_seq, None)

    def restore_at(self, sw: int, pkt: Packet) -> None:
        """Tree restoration (§3.2.1): forward data out the stamped ports."""
        sim = self.sim
        bc = Packet(kind=PacketKind.BCAST, dest=-1, id=pkt.id, value=pkt.value,
                    multicast=True, size_bytes=sim.cfg.mtu_bytes)
        if sim.trace is not None:
            sim.trace.on_bcast_fanout(sw, bc, pkt.restore_ports)
        for port in pkt.restore_ports:
            sim.net.out_port_send(sim, sw, port, bc)


# --------------------------------------------------------------------------
# Algorithm-strategy registry
# --------------------------------------------------------------------------
# Keyed by *string* value (Algo is a str-enum, so built-ins use their enum
# value) — new collectives register under any fresh key without having to
# extend the Algo enum first.
ALGORITHMS: Dict[str, Type["AggregationStrategy"]] = {}


def register_algorithm(algo):
    """Class decorator: bind a strategy to an :class:`Algo` value or any
    string key a new collective wants to go by."""

    def deco(cls: Type["AggregationStrategy"]) -> Type["AggregationStrategy"]:
        cls.algo = algo
        ALGORITHMS[str(algo)] = cls
        return cls

    return deco


def make_strategy(algo, sim) -> "AggregationStrategy":
    try:
        cls = ALGORITHMS[str(algo)]
    except KeyError:
        raise ValueError(f"no strategy registered for algorithm {algo!r}; "
                         f"registered: {sorted(ALGORITHMS)}") from None
    return cls(sim)


class AggregationStrategy:
    """How one collective algorithm uses the fabric.

    The defaults implement a *host-based* algorithm riding a cursor-less
    send queue: switches forward everything, hosts drive the protocol via
    :meth:`on_host_packet`. In-network algorithms override the switch hooks.
    """

    algo: Algo
    leader_skips_self = False  # CANARY: the leader keeps its contribution local
    uses_retx_timers = False   # CANARY: host-side loss detection (§3.3)
    # True when the strategy allocates per-switch descriptors — the resource
    # the fleet admission controller budgets (§3.2.2). Host-based strategies
    # (RING) keep the default and are always admitted without a quota.
    uses_switch_memory = False
    # True when generation-bumped FAIL resends must bypass in-network
    # aggregation (plan-driven strategies: a static plan has no notion of a
    # partial cohort, so a resent generation routed through it deadlocks on
    # the leader's never-resent leaf contribution). Read by
    # HostProtocol.host_handle_fail when a transport policy owns block retx.
    fail_resend_bypass = False
    # telemetry site state, installed by Telemetry.start() and retracted by
    # the hub when a site goes cold (all blocks opened / instant log full):
    # _tel_open is the hub's block_open dict (first-send detection),
    # _tel_pkt is the hub's raw per-packet instant log while instants are
    # wanted (the site appends and retracts itself at _tel_pkt_cap).
    # Pre-binding the state into ONE attribute keeps the hot sites at a
    # single load + identity check (see ARCHITECTURE.md §Telemetry).
    _tel_open = None
    _tel_pkt = None
    _tel_pkt_cap = 0

    def __init__(self, sim):
        self.sim = sim
        # per-run hot-path bindings (every layer the hooks touch exists
        # before strategies are constructed)
        cfg = sim.cfg
        self._engine = sim.engine
        self._push = sim.engine.push
        self._push_timer = sim.engine.push_timer
        self._fwd_host = sim.net.forward_toward_host
        self._pool = sim.pool
        self._trace = sim.trace
        self._transport = sim.transport
        # inlined descriptor telemetry site state (None/0 when telemetry is
        # off), installed by Telemetry.finalize() — the hub is constructed
        # after the layers (heap-locality, see Simulator). _tel_sw_hi is the
        # hub's exact per-switch occupancy high-water list, _tel_desc_log
        # its raw flush log ((sw, desc, reason, nchildren, t) records up to
        # _tel_desc_cap entries, then slim (reason, duration) pairs for the
        # window histogram only), and
        # _tel_desc_n counts allocs. Inlining keeps the per-descriptor
        # sites at a few attribute loads instead of a bound-method call;
        # the hub decodes the log once, lazily, after the run.
        self._telemetry = None
        self._tel_sw_hi = None
        self._tel_desc_log = None
        self._tel_desc_cap = 0
        self._tel_desc_n = 0
        self._mtu = cfg.mtu_bytes
        self._retx_timeout = cfg.retx_timeout_ns
        # per-app send constants, built lazily on first pump (after
        # activation, so the admission degrade decision is already made):
        # (B, parts, p, fixed_leader, nhosts, size, degraded, plain, abase)
        self._send_cache: Dict[int, tuple] = {}

    # ---- job setup ---------------------------------------------------------
    def setup_job(self, app: int, job, parts: List[int]) -> None:
        """Default: every participant streams its blocks via a lazy cursor.

        Pumps are scheduled at ``sim.now`` — 0.0 for construction-time jobs,
        the arrival/admission time for open-loop (fleet) jobs.
        """
        sim = self.sim
        hp = sim.hostproto
        for h in parts:
            hp.hosts[h].send_cursor.append([app, 0])
            hp.schedule_pump(h, sim.now)

    # ---- host send generation ---------------------------------------------
    def _send_consts(self, app: int) -> tuple:
        """Per-app constants for the cursor walk. Safe to cache: the
        participant list, leader map, wire size and the admission degrade
        decision are all fixed before ``setup_job`` schedules the first
        pump (a retx *fallback* is per-block state, not per-app)."""
        sim = self.sim
        parts = sim.leaders[app]
        consts = (sim.blocks[app], parts, len(parts),
                  sim._leader_fixed.get(app), sim.nparts[app],
                  sim.pkt_bytes[app], app in sim.bypass_apps,
                  app not in sim._barrier_apps
                  and app not in sim._contrib_root,
                  7919 * app)
        self._send_cache[app] = consts
        return consts

    def invalidate_send_cache(self, app: int) -> None:
        """Drop the cached per-app send constants. The fault-escalation path
        (repro.core.faults) flips ``app`` into ``sim.bypass_apps`` mid-run —
        the one post-setup event that changes the cached ``degraded`` flag."""
        self._send_cache.pop(app, None)

    def next_host_packet(self, host: int) -> Optional[Packet]:
        """Produce this host's next allreduce send (monolith cursor walk)."""
        sim = self.sim
        hs = sim.hostproto.hosts[host]
        cache = self._send_cache
        for cur in hs.send_cursor:
            app, nxt = cur
            consts = cache.get(app)
            if consts is None:
                consts = self._send_consts(app)
            B, parts, p, fixed, nhosts, size, degraded, plain, abase = consts
            # admission-degraded apps ride the §3.3 host-based path whatever
            # the strategy: bypass packets straight to the leader, which
            # keeps its own contribution local and unicasts the result
            if self.leader_skips_self or degraded:
                if fixed is None:
                    while nxt < B and parts[nxt % p] == host:
                        nxt += 1  # leader keeps its contribution local (§3.1.4)
                elif fixed == host:
                    nxt = B
            if nxt < B:
                cur[1] = nxt + 1
                pkt = self._pool.alloc()
                pkt.kind = PacketKind.REDUCE
                pkt.dest = parts[nxt % p] if fixed is None else fixed
                pkt.id = (app << APP_SHIFT) | (nxt << GEN_BITS)
                pkt.counter = 1
                pkt.hosts = nhosts
                # inline contribution() for plain allreduce/reduce apps
                pkt.value = (host + 1) * 1000003 + 31 * nxt + abase if plain \
                    else sim.contribution_of(app, nxt, host)
                pkt.bypass = degraded
                pkt.size_bytes = size
                pkt.src = host
                if self._trace is not None:
                    self._trace.on_host_send(host, pkt)
                # telemetry hot-site inlining: only a block's FIRST send is
                # interesting — _tel_open IS the hub's block_open dict while
                # unopened blocks remain (the hub retracts it after the last
                # one), so repeats are rejected without paying a call
                bo = self._tel_open
                if bo is not None and (pkt.id >> GEN_BITS) not in bo:
                    self._telemetry.on_host_send(host, pkt)
                tp = self._transport
                if tp is not None and tp.owns_block_retx:
                    # go-back-N block flows supersede the whole-block timer
                    tp.on_block_sent(host, app, nxt)
                elif self.uses_retx_timers or degraded:
                    # loss detection is part of the Canary protocol (§3.3);
                    # static-tree systems restart from scratch instead.
                    self._push_timer(self._engine.now + self._retx_timeout,
                                     EV_RETX, host, 0, (app, nxt, 0))
                return pkt
            cur[1] = nxt
        return None

    # ---- switch dataplane hooks --------------------------------------------
    def on_switch_reduce(self, sw: int, in_port: int, pkt: Packet) -> None:
        self._fwd_host(self.sim, sw, pkt)

    def on_switch_bcast(self, sw: int, pkt: Packet) -> None:
        self._fwd_host(self.sim, sw, pkt)

    def on_descriptor_timeout(self, sw: int, desc: Descriptor) -> None:
        pass

    # ---- host arrival hook --------------------------------------------------
    def on_host_packet(self, host: int, pkt: Packet) -> bool:
        """Return True when the strategy consumed the packet. A consumed
        linear (non-multicast) packet is recycled by the caller — do not
        retain references to it past this call."""
        return False


@register_algorithm(Algo.CANARY)
class CanaryStrategy(AggregationStrategy):
    """Dynamic trees: timeout aggregation, collisions + restoration (§3)."""

    leader_skips_self = True
    uses_retx_timers = True
    uses_switch_memory = True

    def __init__(self, sim):
        super().__init__(sim)
        cfg = sim.cfg
        sl = sim.switch
        self._switch = sl
        self._tables = sl.tables
        self._slots = sl.slots
        self._desc_high = sl.desc_high
        self._live = sl.live_timers
        self._timeout = cfg.timeout_ns
        self._gc_ns = cfg.gc_ns
        self._table_size = cfg.table_size
        self._partition = cfg.partition_table and len(sim.jobs) > 1

    # ---- descriptor slot hashing -------------------------------------------
    @staticmethod
    def _hash64(pid: int) -> int:
        # Fibonacci hashing; use the HIGH bits — block ids have zero low bits
        # (generation field), and power-of-two tables would otherwise see only
        # a tiny fraction of their slots.
        return ((pid * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF) >> 24

    def slot_of(self, pid: int) -> int:
        sim = self.sim
        region = sim.slot_regions.get(id_app(pid))
        if region is not None:
            # enforced tenant quota (fleet admission, §3.2.2): this app's
            # descriptors can only ever occupy its tenant's slot region, so
            # a tenant's per-switch footprint is hard-bounded by its quota —
            # overflow within the region collides and bypasses (§3.2.1)
            # instead of stealing another tenant's slots.
            offset, size = region
            return offset + self._hash64(pid) % size
        if self._partition:
            apps = len(sim.jobs)
            region_sz = max(1, self._table_size // apps)
            return (id_app(pid) % apps) * region_sz \
                + self._hash64(pid) % region_sz
        return self._hash64(pid) % self._table_size

    # ---- dataplane ----------------------------------------------------------
    def on_switch_reduce(self, sw: int, in_port: int, pkt: Packet) -> None:
        sim = self.sim
        if pkt.bypass:
            self._fwd_host(sim, sw, pkt)
            return
        pid = pkt.id
        table = self._tables[sw]
        desc = table.get(pid)
        now = self._engine.now
        trace = self._trace
        if desc is not None:
            desc.children.add(in_port)
            desc.last_ns = now
            if desc.sent:
                # straggler (§3.1.1): forward immediately, keep child recorded
                sim.stragglers += 1
                if trace is not None:
                    trace.on_straggler(sw, in_port, pkt)
                ins = self._tel_pkt  # raw instant log while it has room
                if ins is not None:
                    # inlined pkt-instant site: raw packed id, decoded at
                    # consolidation; the site retracts itself when full
                    ins.append(("straggler", sw, pkt.id, now))
                    if len(ins) >= self._tel_pkt_cap:
                        self._tel_pkt = None
                        self._telemetry.want_pkt_instants = False
                self._fwd_host(sim, sw, pkt)
            else:
                desc.value += pkt.value
                desc.counter += pkt.counter
                if trace is not None:
                    trace.on_switch_merge(sw, desc, in_port, pkt)
                if desc.counter >= desc.hosts - 1:
                    self._fire_descriptor(sw, desc)  # all data received (§3.1.4)
                self._pool.free(pkt)  # merged: packet consumed
            return
        if not sim.slot_regions and not self._partition:
            slot = (((pid * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
                    >> 24) % self._table_size
        else:
            slot = self.slot_of(pid)
        slots = self._slots[sw]
        occupant = slots.get(slot)
        if occupant is not None:
            odesc = table.get(occupant)
            if odesc is None:
                slots.pop(slot, None)
                occupant = None
            elif now - odesc.last_ns > self._gc_ns:
                # stale soft state (abandoned generation): garbage collect
                self._switch.dealloc(sw, odesc)
                occupant = None
        if occupant is not None:
            # collision (§3.2.1): stamp and bypass straight to the leader
            sim.collisions += 1
            if trace is not None:
                trace.on_collision(sw, in_port, pkt)
            ins = self._tel_pkt  # raw instant log while it has room
            if ins is not None:
                # inlined pkt-instant site (see the straggler site above)
                ins.append(("collision", sw, pkt.id, now))
                if len(ins) >= self._tel_pkt_cap:
                    self._tel_pkt = None
                    self._telemetry.want_pkt_instants = False
            pkt.switch_addr = sw
            pkt.port_stamp = in_port
            pkt.bypass = True
            self._fwd_host(sim, sw, pkt)
            return
        desc = Descriptor(id=pid, slot=slot, value=pkt.value,
                          counter=pkt.counter, hosts=pkt.hosts,
                          children={in_port}, alloc_ns=now,
                          last_ns=now)
        table[pid] = desc
        slots[slot] = pid
        dh = self._desc_high
        n = len(table)
        if n > dh[sw]:
            dh[sw] = n
        if trace is not None:
            trace.on_desc_alloc(sw, desc, in_port, pkt)
        hi = self._tel_sw_hi
        if hi is not None:
            # inlined on_desc_alloc: occupancy only rises at an alloc, so
            # the event-driven high-water stays exact at any probe cadence
            self._tel_desc_n += 1
            if n > hi[sw]:
                hi[sw] = n
        if desc.counter >= desc.hosts - 1:
            self._fire_descriptor(sw, desc)
            self._pool.free(pkt)
            return
        sl = self._switch
        sl.timer_seq = tseq = sl.timer_seq + 1
        desc.timer_seq = tseq
        self._live[tseq] = desc
        self._push_timer(now + self._timeout, EV_TIMER, sw, tseq, pid)
        self._pool.free(pkt)

    def _fire_descriptor(self, sw: int, desc: Descriptor,
                         reason: str = "complete") -> None:
        """Timeout (or early completion): forward the partial aggregate (§3.1.1)."""
        sim = self.sim
        desc.sent = True
        if desc.timer_seq:
            # early completion: lazily cancel the armed timer (the heap
            # entry stays; its pop misses live_timers and is dropped)
            self._live.pop(desc.timer_seq, None)
        did = desc.id
        leader = sim.leader_of(did >> APP_SHIFT, (did >> GEN_BITS) & BLOCK_MASK)
        out = self._pool.alloc()
        out.kind = PacketKind.REDUCE
        out.dest = leader
        out.id = did
        out.counter = desc.counter
        out.hosts = desc.hosts
        out.value = desc.value
        out.size_bytes = self._mtu
        # switch-originated aggregate: no single culprit sender (a stale
        # pooled src would misdirect transport CNPs/PFC pauses)
        out.src = -1
        if self._trace is not None:
            self._trace.on_desc_flush(sw, desc, out, reason)
        dlog = self._tel_desc_log
        if dlog is not None:
            # inlined on_desc_flush: raw-log the aggregation window. The
            # descriptor itself is retained (descriptors are not pooled, so
            # nothing aliases it later) and the hub reads id/counter/
            # alloc_ns off it lazily after the run — only the child count
            # must be captured here, because stragglers keep mutating the
            # children set after the flush. Past the span cap only
            # (reason, duration) survives, so retention stays bounded.
            t = self._engine.now
            if len(dlog) < self._tel_desc_cap:
                dlog.append((sw, desc, reason, len(desc.children), t))
            else:
                dlog.append((reason, t - desc.alloc_ns))
        self._fwd_host(sim, sw, out)

    def on_descriptor_timeout(self, sw: int, desc: Descriptor) -> None:
        self._fire_descriptor(sw, desc, reason="timeout")

    def on_switch_bcast(self, sw: int, pkt: Packet) -> None:
        sim = self.sim
        desc = self._tables[sw].get(pkt.id)
        if desc is None:
            # collision happened here during reduce: drop; the leader's
            # restoration packet re-attaches this subtree (§3.2.1)
            return
        if self._trace is not None:
            self._trace.on_bcast_fanout(sw, pkt, desc.children)
        out_port_send = sim.net.out_port_send
        for port in desc.children:
            out_port_send(sim, sw, port, pkt)
        self._switch.dealloc(sw, desc)


@register_algorithm(Algo.STATIC_TREE)
class StaticTreeStrategy(AggregationStrategy):
    """N statically-configured reduction trees (N=1 ~ SHARP/SwitchML/ATP;
    N=4 ~ PANAMA). Roots are drawn from the topology's root candidates; the
    per-switch expected-children plan comes from
    :meth:`~.topology.Topology.static_expected`, so the same strategy runs on
    any registered topology."""

    uses_switch_memory = True
    fail_resend_bypass = True

    def __init__(self, sim):
        super().__init__(sim)
        self._tables = sim.switch.tables
        self._desc_high = sim.switch.desc_high
        self.roots: Dict[int, List[int]] = {}          # app -> tree roots
        self.plans: Dict[tuple, Dict[int, int]] = {}   # (app, root) -> plan

    def setup_job(self, app: int, job, parts: List[int]) -> None:
        sim = self.sim
        cands = sim.net.root_candidates()
        roots = [cands[sim.rng.randrange(len(cands))]
                 for _ in range(sim.n_trees)]
        self.roots[app] = roots
        for root in roots:
            if (app, root) not in self.plans:
                self.plans[(app, root)] = sim.net.static_expected(parts, root)
        super().setup_job(app, job, parts)

    def root_of(self, app: int, block: int) -> int:
        roots = self.roots[app]
        return roots[block % len(roots)]

    def on_switch_reduce(self, sw: int, in_port: int, pkt: Packet) -> None:
        sim = self.sim
        if pkt.bypass:
            # admission-degraded app (host-based fallback): never part of the
            # static plan — forward straight toward the leader host
            self._fwd_host(sim, sw, pkt)
            return
        pid = pkt.id
        app = pid >> APP_SHIFT
        roots = self.roots[app]
        root = roots[((pid >> GEN_BITS) & BLOCK_MASK) % len(roots)]
        table = self._tables[sw]
        desc = table.get(pid)
        now = self._engine.now
        if desc is None:
            expected = self.plans[(app, root)][sw]
            desc = Descriptor(id=pid, slot=-1, hosts=pkt.hosts,
                              expected=expected, alloc_ns=now,
                              last_ns=now)
            table[pid] = desc
            dh = self._desc_high
            n = len(table)
            if n > dh[sw]:
                dh[sw] = n
            hi = self._tel_sw_hi
            if hi is not None:  # inlined on_desc_alloc (see CanaryStrategy)
                self._tel_desc_n += 1
                if n > hi[sw]:
                    hi[sw] = n
        desc.children.add(in_port)
        desc.value += pkt.value
        desc.counter += pkt.counter
        desc.last_ns = now
        trace = self._trace
        if trace is not None:
            trace.on_switch_merge(sw, desc, in_port, pkt)
        if len(desc.children) < desc.expected:
            self._pool.free(pkt)
            return
        if sw != root:
            out = self._pool.alloc()
            out.kind = PacketKind.REDUCE
            out.dest = -1
            out.id = pid
            out.counter = desc.counter
            out.hosts = pkt.hosts
            out.value = desc.value
            out.size_bytes = self._mtu
            out.src = -1  # switch-originated aggregate (see CanaryStrategy)
            if trace is not None:
                trace.on_desc_flush(sw, desc, out, "complete")
            dlog = self._tel_desc_log
            if dlog is not None:  # inlined on_desc_flush (see CanaryStrategy)
                if len(dlog) < self._tel_desc_cap:
                    dlog.append((sw, desc, "complete",
                                 len(desc.children), now))
                else:
                    dlog.append(("complete", now - desc.alloc_ns))
            sim.net.static_send_up(sim, sw, root, out)
            desc.sent = True
        else:
            bc = Packet(kind=PacketKind.BCAST, dest=-1, id=pid,
                        value=desc.value, multicast=True,
                        size_bytes=self._mtu)
            if trace is not None:
                trace.on_static_root_done(sw, desc)
                trace.on_bcast_fanout(sw, bc, desc.children)
            out_port_send = sim.net.out_port_send
            for port in desc.children:
                out_port_send(sim, sw, port, bc)
            table.pop(pid, None)
            dlog = self._tel_desc_log
            if dlog is not None:  # inlined on_desc_flush (see CanaryStrategy)
                if len(dlog) < self._tel_desc_cap:
                    dlog.append((sw, desc, "complete",
                                 len(desc.children), now))
                else:
                    dlog.append(("complete", now - desc.alloc_ns))
        self._pool.free(pkt)

    def on_switch_bcast(self, sw: int, pkt: Packet) -> None:
        sim = self.sim
        table = self._tables[sw]
        desc = table.get(pkt.id)
        if desc is None:
            return
        net = sim.net
        if self._trace is not None:
            self._trace.on_bcast_fanout(
                sw, pkt,
                [p for p in desc.children if not net.is_up_port(sw, p)])
        out_port_send = net.out_port_send
        is_up_port = net.is_up_port
        for port in desc.children:
            if is_up_port(sw, port):
                continue  # never broadcast back up the tree
            out_port_send(sim, sw, port, pkt)
        table.pop(pkt.id, None)
