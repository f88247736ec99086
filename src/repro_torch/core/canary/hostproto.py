"""Host protocol layer: send pump, leader recovery, retransmission.

Everything a *host* NIC/CPU does lives here (see ``ARCHITECTURE.md``):

* :class:`HostProtocol` — per-host send queues and the pump (one in-flight
  packet per NIC, rescheduled at line rate), block-completion accounting, and
  the Canary leader role: final aggregation (§3.1.4), broadcast +
  tree-restoration kickoff (§3.2.1), loss recovery and generation management
  (§3.3).
* :class:`RingStrategy` — the host-based ring allreduce baseline. It is an
  :class:`~.switch.AggregationStrategy` like CANARY/STATIC_TREE, registered
  in the same registry; switches simply forward its packets (the base-class
  default), which is precisely what makes it "host-based".

Hot-path notes (ARCHITECTURE.md §Performance): ``handle_pump`` is the
``EV_PUMP`` handler itself (no facade trampoline) and draws from pre-resolved
bindings set up in :meth:`HostProtocol.finalize`; ``arrive`` recycles every
*linear* (non-multicast) packet through ``sim.pool`` once it has been fully
processed — a packet delivered to a host is at end-of-life unless it is a
multicast broadcast fan-out, whose object is shared across links.
"""
from __future__ import annotations

from collections import deque
from heapq import heappush as _heappush
from typing import Deque, Dict, List, Optional, Set, Tuple

from .engine import EV_LEADER_DONE, EV_PUMP, EV_RETX
from .switch import AggregationStrategy, register_algorithm
from .types import (APP_SHIFT, Algo, BLOCK_MASK, GEN_BITS, Packet, PacketKind,
                    id_app, id_block, id_gen, make_id)

_MAX_GEN = (1 << GEN_BITS) - 1
_K_REDUCE = int(PacketKind.REDUCE)
_K_BCAST = int(PacketKind.BCAST)
_K_RETX_REQ = int(PacketKind.RETX_REQ)
_K_FAIL = int(PacketKind.FAIL)
_K_UNICAST = int(PacketKind.UNICAST_DATA)
_K_NOISE = int(PacketKind.NOISE)

# Transport-policy verdicts for the pump gate (repro.core.transport.base):
# ``before_send`` returns one of these sentinels (identity-compared), a float
# release time, or None to let the packet go. TX_PAUSED parks the packet in
# ``pending`` with NO pump event scheduled — the policy's resume event must
# call ``schedule_pump``. TX_ABSORBED means the policy took ownership of the
# packet (window stall, stale clone); the pump re-fires immediately for the
# host's next packet.
TX_PAUSED = object()
TX_ABSORBED = object()


class _HostState:
    __slots__ = ("queue", "pending", "pump_scheduled", "noise_peer",
                 "noise_remaining", "noise_msg_idx", "noise_buf",
                 "send_cursor")

    def __init__(self) -> None:
        self.queue: Deque[Packet] = deque()
        self.pending: Optional[Packet] = None
        self.pump_scheduled = False
        self.noise_peer = -1
        self.noise_remaining = 0
        self.noise_msg_idx = 0
        # rest of the current background-noise message, pre-built (the
        # workload layer batches generation per message; see workloads.py)
        self.noise_buf: List[Packet] = []
        # lazy cursor over this host's allreduce contributions: [app, next_block]
        self.send_cursor: List[List[int]] = []


class _LeaderState:
    __slots__ = ("value", "counter", "gen", "restorations", "done",
                 "last_fail_ns", "pending_done", "contributed")

    def __init__(self) -> None:
        self.value = 0
        self.counter = 0
        self.gen = 0
        self.restorations: List[Tuple[int, int]] = []
        self.done = False
        self.pending_done = False
        self.last_fail_ns = -1e18
        # go-back-N only: src hosts already merged into the current partial.
        # Lets saturated-generation resends accumulate without double counts
        # (under "none" the set stays empty — generation discipline dedups).
        self.contributed: Set[int] = set()


class HostProtocol:
    """Per-host send machinery + the leader/reliability protocol."""

    def __init__(self, sim, num_hosts: int):
        self.sim = sim
        self.hosts = [_HostState() for _ in range(num_hosts)]
        self.host_gen: Dict[Tuple[int, int, int], int] = {}  # (host, app, block)
        self.leader_state: Dict[Tuple[int, int], _LeaderState] = {}
        self.completed_total: Dict[Tuple[int, int], int] = {}
        self.fallback_blocks: Set[Tuple[int, int]] = set()
        # per-run hot-path bindings, filled by finalize()
        self._engine = sim.engine
        self._push = sim.engine.push
        self._push_timer = sim.engine.push_timer
        self._send_from_host = sim.net.send_from_host
        self._pool_free = sim.pool.free
        self._next_strategy_pkt = None
        self._on_host_packet = None
        self._next_noise_pkt = None
        self._sender_delay = None
        self._noise_prob = sim.cfg.noise_prob
        # transport policy (None under the default "none" — every hook below
        # is guarded by one identity check, the trace-recorder pattern)
        self._transport = None
        self._telemetry = None
        # telemetry site state, installed by Telemetry.start(): the hub's
        # block_left countdown dict while spans are on, else None — one load
        # + identity check gates the whole completion hook
        self._tel_left = None
        self._fail_resend_bypass = False
        self._gbn = False  # transport owns block retx (go-back-N recovery)
        # fault-injection state (repro.core.faults): the schedule object
        # (None without one — every hook is one identity check) and the
        # live paused-host set a host_slow fault installs
        self._faults = None
        self._fault_paused = None

    def finalize(self) -> None:
        """Pre-resolve the strategy/workload callables (both layers are
        constructed after this one). Called by the facade once per run."""
        sim = self.sim
        self._next_strategy_pkt = sim.strategy.next_host_packet
        self._on_host_packet = sim.strategy.on_host_packet
        self._next_noise_pkt = sim.workload.next_noise_packet
        self._sender_delay = sim.workload.sender_delay_ns
        self._transport = sim.transport
        self._telemetry = sim.telemetry
        self._fail_resend_bypass = sim.strategy.fail_resend_bypass
        self._gbn = self._transport is not None \
            and self._transport.owns_block_retx
        self._faults = getattr(sim, "faults", None)

    # ------------------------------------------------------------ send pump
    def schedule_pump(self, host: int, t: float) -> None:
        hs = self.hosts[host]
        if not hs.pump_scheduled:
            hs.pump_scheduled = True
            self._push(t, EV_PUMP, host, 0, None)

    def handle_pump(self, host: int, _b: int, _c: object) -> None:
        """The ``EV_PUMP`` handler: send this host's next packet, if any."""
        hs = self.hosts[host]
        hs.pump_scheduled = False
        sim = self.sim
        if self._engine.stop:  # == sim.all_done(): set in job_finished
            return
        fp = self._fault_paused
        if fp is not None and host in fp:
            # host_slow fault (repro.core.faults): the straggler's pump is
            # parked; the heal re-pumps every paused host
            return
        pkt = hs.pending
        if pkt is None:
            queue = hs.queue
            if queue:
                pkt = queue.popleft()
            else:
                # the strategy walk reads only send_cursor (contract shared
                # by every strategy: queue-driven ones enqueue into hs.queue)
                pkt = self._next_strategy_pkt(host) if hs.send_cursor else None
                if pkt is None:
                    buf = hs.noise_buf
                    pkt = buf.pop() if buf \
                        else self._next_noise_pkt(host, hs)
                    if pkt is None:
                        return
            # §5.2.5 sender-side OS noise: delay this send with probability p.
            if self._noise_prob:
                delay = self._sender_delay(host)
                if delay is not None:
                    hs.pending = pkt
                    hs.pump_scheduled = True
                    self._push(self._engine.now + delay, EV_PUMP, host, 0,
                               None)
                    return
        else:
            hs.pending = None
        tp = self._transport
        if tp is not None:
            verdict = tp.before_send(host, pkt)
            if verdict is not None:
                if verdict is TX_PAUSED:
                    # parked until the policy's resume event re-pumps; no
                    # event outstanding, so pump_scheduled must stay False
                    hs.pending = pkt
                    return
                if verdict is TX_ABSORBED:
                    # policy took the packet (window stall / stale clone);
                    # immediately try the host's next packet
                    hs.pump_scheduled = True
                    self._push(self._engine.now, EV_PUMP, host, 0, None)
                    return
                # float: rate-paced — hold the packet until the release time
                hs.pending = pkt
                hs.pump_scheduled = True
                self._push(verdict, EV_PUMP, host, 0, None)
                return
        nic_free = self._send_from_host(sim, host, pkt)
        if tp is not None:
            nic_free = tp.after_send(host, pkt, nic_free)
        hs.pump_scheduled = True
        eng = self._engine
        eng._seq = seq = eng._seq + 1
        _heappush(eng.heap, (nic_free, seq, EV_PUMP, host, 0, None))

    # ----------------------------------------------------------- completion
    def complete_at_host(self, host: int, app: int, block: int,
                         value: int) -> None:
        sim = self.sim
        flags = sim.have.get((app, host))
        if flags is None or flags[block]:
            return
        flags[block] = 1
        if sim.trace is not None:
            sim.trace.on_host_complete(host, app, block)
        # telemetry hot-site inlining: _tel_left IS the hub's per-block
        # countdown dict (spans on) — decrement in place and only pay a call
        # for the LAST completion of a block, which closes its lifecycle span
        tl = self._tel_left
        if tl is not None:
            arr = tl[app]
            n = arr[block] - 1
            arr[block] = n
            if n <= 0:
                self._telemetry.on_block_complete(host, app, block)
        tp = self._transport
        if tp is not None and tp.owns_block_retx:
            tp.on_block_complete(host, app, block)
            # memo the reduced value at the leader so later RETX_REQs can be
            # served even when the completion path bypassed leader_block_done
            if host == sim.leader_of(app, block):
                key = (app, block)
                if key not in self.completed_total:
                    self.completed_total[key] = value
        if value != sim.expected_total(app, block):
            sim.mismatches += 1
        remaining = sim.app_remaining[app] - 1
        sim.app_remaining[app] = remaining
        sim.completed_blocks += 1
        if remaining == 0:
            sim.job_finished(app)

    # ---------------------------------------------------------- leader role
    def leader_block_done(self, host: int, app: int, block: int,
                          total: int) -> None:
        sim = self.sim
        key = (app, block)
        st = self.leader_state.get(key)
        if st is None or st.done:
            return
        st.done = True
        self.completed_total[key] = total
        if self._telemetry is not None:
            # before complete_at_host: the broadcast sub-span opens at the
            # leader-done instant, ahead of any participant completion
            self._telemetry.on_leader_done(host, app, block)
        self.complete_at_host(host, app, block, total)
        if sim.jobs[app].collective == "reduce":
            return  # §6: a reduce skips the broadcast phase entirely
        pid = make_id(app, block, st.gen)
        cfg = sim.cfg
        if key in self.fallback_blocks or app in sim.bypass_apps:
            # host-based fallback (§3.3): no descriptors exist — unicast result
            for h in sim.leaders[app]:
                if h == host:
                    continue
                up = Packet(kind=PacketKind.UNICAST_DATA, dest=h, id=pid,
                            value=total, size_bytes=cfg.mtu_bytes, src=host)
                self.hosts[host].queue.append(up)
        else:
            # broadcast down the recorded tree (§3.1.2)
            bc = Packet(kind=PacketKind.BCAST, dest=-1, id=pid, value=total,
                        multicast=True, size_bytes=cfg.mtu_bytes)
            self.hosts[host].queue.append(bc)
            # tree restoration for collided subtrees (§3.2.1)
            by_switch: Dict[int, List[int]] = {}
            for sw_addr, port in st.restorations:
                by_switch.setdefault(sw_addr, []).append(port)
            for sw_addr, ports in by_switch.items():
                sim.restorations += 1
                rp = Packet(kind=PacketKind.RESTORE, dest=-1, id=pid,
                            value=total, dest_switch=sw_addr,
                            restore_ports=tuple(set(ports)),
                            size_bytes=cfg.mtu_bytes)
                if sim.trace is not None:
                    sim.trace.on_restore(pid, sw_addr, rp.restore_ports)
                self.hosts[host].queue.append(rp)
        self.schedule_pump(host, sim.now)

    # --------------------------------------------------------- host arrival
    def handle_arrive(self, host: int, _b: int, pkt: Packet) -> None:
        """The ``EV_ARRIVE_HOST`` handler. Processes the packet, then
        recycles it unless it is a shared multicast object."""
        sim = self.sim
        tp = self._transport
        if tp is not None:
            # CNP/ACK consumption, ECN-echo, go-back-N sequencing. A None
            # return means the policy consumed (and recycled) the packet.
            pkt = tp.on_receive(host, pkt)
            if pkt is None:
                return
        kind = pkt.kind
        if kind == _K_NOISE:
            self._pool_free(pkt)
            return
        if self._on_host_packet(host, pkt):
            if not pkt.multicast:
                self._pool_free(pkt)
            return
        pid = pkt.id
        app = pid >> APP_SHIFT
        block = (pid >> GEN_BITS) & BLOCK_MASK
        if kind == _K_REDUCE:
            if sim.leader_of(app, block) == host:
                key = (app, block)
                st = self.leader_state.get(key)
                if st is None:
                    st = self.leader_state[key] = _LeaderState()
                gen = pid & _MAX_GEN
                if not (st.done or st.pending_done or gen != st.gen) \
                        and not (self._gbn and pkt.src >= 0
                                 and pkt.src in st.contributed):
                    if self._gbn and pkt.src >= 0:
                        st.contributed.add(pkt.src)
                    st.value += pkt.value
                    st.counter += pkt.counter
                    if sim.trace is not None:
                        sim.trace.on_leader_merge(host, pkt)
                    if pkt.switch_addr >= 0:
                        st.restorations.append((pkt.switch_addr,
                                                pkt.port_stamp))
                    if st.counter >= sim.nparts[app] - 1:
                        total = st.value + sim.contribution_of(app, block,
                                                               host)
                        st.pending_done = True
                        if sim.trace is not None:
                            sim.trace.on_leader_complete(host, app, block,
                                                         gen)
                        # leader-side aggregation cost r (§3.2.2)
                        self._push(self._engine.now
                                   + sim.cfg.leader_aggregate_ns,
                                   EV_LEADER_DONE, host, 0,
                                   (app, block, total))
            self._pool_free(pkt)
            return
        if kind == _K_BCAST or kind == _K_UNICAST:
            self.complete_at_host(host, app, block, pkt.value)
            if not pkt.multicast:
                self._pool_free(pkt)
            return
        if kind == _K_RETX_REQ:
            self.leader_handle_retx(host, app, block, pkt.src)
            self._pool_free(pkt)
            return
        if kind == _K_FAIL:
            self.host_handle_fail(host, pkt)
            self._pool_free(pkt)
            return

    def arrive(self, host: int, pkt: Packet) -> None:
        """Compat entry point (the engine dispatches ``handle_arrive``)."""
        self.handle_arrive(host, 0, pkt)

    # ----------------------------------------------------------- reliability
    def leader_handle_retx(self, leader: int, app: int, block: int,
                           requester: int) -> None:
        sim = self.sim
        cfg = sim.cfg
        key = (app, block)
        total = self.completed_total.get(key)
        if total is not None:
            # loss was in the broadcast phase: retransmit reduced data (§3.3)
            up = Packet(kind=PacketKind.UNICAST_DATA, dest=requester,
                        id=make_id(app, block, 0), value=total,
                        size_bytes=cfg.mtu_bytes, src=leader)
            self.hosts[leader].queue.append(up)
            self.schedule_pump(leader, sim.now)
            return
        st = self.leader_state.get(key)
        if st is None:
            st = self.leader_state[key] = _LeaderState()
        if st.pending_done:
            return  # completion already in flight
        if sim.now - st.last_fail_ns < cfg.retx_timeout_ns / 2:
            return  # debounce: a failure round is already in flight
        st.last_fail_ns = sim.now
        newgen = min(st.gen + 1, _MAX_GEN)
        fallback = newgen >= cfg.max_generations
        if fallback and key not in self.fallback_blocks:
            sim.fallbacks += 1
            self.fallback_blocks.add(key)
            if app not in sim.bypass_apps:
                # admission-degraded apps were counted whole at activation
                sim.app_fallback_blocks[app] = \
                    sim.app_fallback_blocks.get(app, 0) + 1
                fa = self._faults
                if fa is not None and fa.any_active():
                    # generation cap hit while a fault is live: the fabric
                    # path is (probably) the casualty — escalate the whole
                    # app to the §3.3 host-based fallback rather than let
                    # later blocks spin through the cap too (the documented
                    # agg-switch livelock)
                    fa.escalate_app(app)
        # Generation ids saturate at _MAX_GEN. Under go-back-N the saturated
        # rounds keep ONE accumulating partial (src-deduped above) instead of
        # restarting — each host's resend then only has to get through once
        # ever, so recovery converges at any loss rate. Pre-saturation (and
        # always under "none") a new generation starts from scratch.
        if not (self._gbn and newgen == st.gen
                and (fallback or self._fail_resend_bypass)):
            st.value = 0
            st.counter = 0
            st.restorations = []
            st.contributed.clear()
        st.gen = newgen
        # "the leader broadcasts a failure message" (§3.3) — delivered unicast
        for h in sim.leaders[app]:
            if h == leader:
                continue
            fl = Packet(kind=PacketKind.FAIL, dest=h,
                        id=make_id(app, block, newgen),
                        counter=1 if fallback else 0,
                        size_bytes=cfg.header_bytes + 16, src=leader)
            self.hosts[leader].queue.append(fl)
        self.schedule_pump(leader, sim.now)

    def host_handle_fail(self, host: int, pkt: Packet) -> None:
        sim = self.sim
        cfg = sim.cfg
        app, block, gen = id_app(pkt.id), id_block(pkt.id), id_gen(pkt.id)
        hkey = (host, app, block)
        tp = self._transport
        gbn = self._gbn
        prev = self.host_gen.get(hkey, 0)
        if prev > gen or (prev == gen and not gbn):
            # under go-back-N a same-generation FAIL re-triggers the resend
            # (the earlier copy may have been lost; the leader's src dedup
            # absorbs duplicates) — saturated generations depend on this
            return
        flags = sim.have.get((app, host))
        if flags is not None and flags[block] and not gbn:
            # under go-back-N a completed host still re-contributes: the new
            # generation's cohort needs every contribution to converge
            return
        self.host_gen[hkey] = gen
        sim.retransmissions += 1
        if self._telemetry is not None:
            self._telemetry.on_retx("fail", host, app, block)
        fallback = pkt.counter == 1 or app in sim.bypass_apps
        # Plan-driven strategies (static tree) have no per-generation switch
        # state: a resent cohort routed through the plan waits forever for
        # the leader's (never resent) leaf contribution. Under a transport
        # that owns block recovery, resends bypass the fabric aggregation
        # and sum at the leader host instead.
        # fail_resend_bypass generalizes to mid-run deaths: with a fault
        # schedule present, a resent cohort routed through the plan could be
        # waiting on a switch whose descriptors a crash just flushed
        bypass = fallback or (self._fail_resend_bypass
                              and (gbn or self._faults is not None))
        rp = Packet(kind=PacketKind.REDUCE, dest=sim.leader_of(app, block),
                    id=make_id(app, block, gen), counter=1,
                    hosts=len(sim.leaders[app]),
                    value=sim.contribution_of(app, block, host),
                    bypass=bypass, size_bytes=cfg.mtu_bytes, src=host)
        if sim.trace is not None:
            sim.trace.on_host_send(host, rp)
        self.hosts[host].queue.append(rp)
        if gbn:
            if flags is not None and not flags[block]:
                tp.on_block_sent(host, app, block)
        else:
            self._push_timer(sim.now + cfg.retx_timeout_ns, EV_RETX, host, 0,
                             (app, block, gen))
        self.schedule_pump(host, sim.now)

    def handle_retx(self, host: int, _b: int, c: object) -> None:
        """The ``EV_RETX`` handler."""
        app, block, gen = c
        self.host_retx_check(host, app, block, gen)

    def handle_leader_done(self, host: int, _b: int, c: object) -> None:
        """The ``EV_LEADER_DONE`` handler."""
        app, block, total = c
        self.leader_block_done(host, app, block, total)

    def host_retx_check(self, host: int, app: int, block: int,
                        gen: int) -> None:
        sim = self.sim
        cfg = sim.cfg
        if sim.apps_active == 0:
            return
        flags = sim.have.get((app, host))
        if flags is None or flags[block]:
            return
        if self.host_gen.get((host, app, block), 0) > gen:
            return  # a newer generation is already in flight
        sim.retransmissions += 1
        if self._telemetry is not None:
            self._telemetry.on_retx("request", host, app, block)
        req = Packet(kind=PacketKind.RETX_REQ, dest=sim.leader_of(app, block),
                     id=make_id(app, block, gen),
                     size_bytes=cfg.header_bytes + 16, src=host)
        self.hosts[host].queue.append(req)
        self._push_timer(sim.now + cfg.retx_timeout_ns, EV_RETX, host, 0,
                         (app, block, gen))
        self.schedule_pump(host, sim.now)

    def gbn_request_block(self, host: int, app: int, block: int) -> None:
        """Re-request a block result from its leader on behalf of the
        go-back-N block flow. Unlike :meth:`host_retx_check` this never arms
        an ``EV_RETX`` timer — the transport's per-flow timer owns the retry
        cadence and calls back here each round."""
        sim = self.sim
        if sim.apps_active == 0:
            return
        flags = sim.have.get((app, host))
        if flags is None or flags[block]:
            return
        gen = self.host_gen.get((host, app, block), 0)
        sim.retransmissions += 1
        if self._telemetry is not None:
            self._telemetry.on_retx("request", host, app, block)
        req = Packet(kind=PacketKind.RETX_REQ, dest=sim.leader_of(app, block),
                     id=make_id(app, block, gen),
                     size_bytes=sim.cfg.header_bytes + 16, src=host)
        self.hosts[host].queue.append(req)
        self.schedule_pump(host, sim.now)


# --------------------------------------------------------------------------
# Host-based ring allreduce — same registry as the in-network strategies
# --------------------------------------------------------------------------
class _RingState:
    """Per-app ring-allreduce bookkeeping."""

    __slots__ = ("order", "rank", "p", "chunk_vals", "recv_count", "steps",
                 "pkts_per_chunk", "chunk_bytes", "done_steps")

    def __init__(self, order: List[int], data_bytes: int, payload: int) -> None:
        self.order = order
        self.rank = {h: r for r, h in enumerate(order)}
        self.p = len(order)
        self.chunk_bytes = max(1, -(-data_bytes // self.p))
        self.pkts_per_chunk = max(1, -(-self.chunk_bytes // payload))
        self.steps = 2 * self.p - 2
        self.chunk_vals: List[List[int]] = []
        self.recv_count: List[Dict[int, int]] = []
        self.done_steps: List[int] = []


@register_algorithm(Algo.RING)
class RingStrategy(AggregationStrategy):
    """Bandwidth-optimal host-based ring: reduce-scatter + all-gather.

    Switches only forward (base-class defaults); the whole protocol runs in
    :meth:`on_host_packet` + the per-step send enqueues."""

    def __init__(self, sim):
        super().__init__(sim)
        self.ring: Dict[int, _RingState] = {}

    def setup_job(self, app: int, job, parts: List[int]) -> None:
        sim = self.sim
        from .simulator import contribution
        rs = _RingState(parts, job.data_bytes, sim.cfg.payload_bytes)
        rs.chunk_vals = [
            [contribution(app, c, parts[r]) for c in range(rs.p)]
            for r in range(rs.p)
        ]
        rs.recv_count = [dict() for _ in range(rs.p)]
        rs.done_steps = [0] * rs.p
        self.ring[app] = rs
        for h in parts:
            self._enqueue_send(app, h, step=0)

    def next_host_packet(self, host: int) -> Optional[Packet]:
        return None  # ring sends are queue-driven, not cursor-driven

    def on_host_packet(self, host: int, pkt: Packet) -> bool:
        if pkt.kind != PacketKind.RING:
            return False
        self._receive(host, pkt)
        return True

    # ---- protocol ----------------------------------------------------------
    def _enqueue_send(self, app: int, host: int, step: int) -> None:
        sim = self.sim
        rs = self.ring[app]
        r = rs.rank[host]
        if step > rs.steps - 1:
            return
        c = (r - step) % rs.p
        dest = rs.order[(r + 1) % rs.p]
        val = rs.chunk_vals[r][c]
        payload = sim.cfg.payload_bytes
        header = sim.cfg.header_bytes
        alloc = self._pool.alloc
        remaining = rs.chunk_bytes
        last = rs.pkts_per_chunk - 1
        queue = sim.hostproto.hosts[host].queue
        for i in range(rs.pkts_per_chunk):
            take = payload if remaining >= payload else remaining
            remaining -= take
            pkt = alloc()
            pkt.kind = PacketKind.RING
            pkt.dest = dest
            pkt.id = app
            pkt.value = val if i == last else 0
            pkt.size_bytes = take + header
            pkt.src = host
            pkt.chunk = c
            pkt.step = step
            queue.append(pkt)
        sim.hostproto.schedule_pump(host, sim.now)

    def _receive(self, host: int, pkt: Packet) -> None:
        app = pkt.id
        rs = self.ring[app]
        r = rs.rank[host]
        counts = rs.recv_count[r]
        step = pkt.step
        got = counts.get(step, 0) + 1
        counts[step] = got
        if pkt.value:
            if step < rs.p - 1:
                rs.chunk_vals[r][pkt.chunk] += pkt.value  # reduce-scatter phase
            else:
                rs.chunk_vals[r][pkt.chunk] = pkt.value   # all-gather phase
        if got < rs.pkts_per_chunk:
            return
        counts.pop(step, None)
        rs.done_steps[r] += 1
        if step + 1 <= rs.steps - 1:
            self._enqueue_send(app, host, step + 1)
        # steps can *complete* out of order when paths differ; the host is
        # finished only once every step's chunk has fully arrived.
        if rs.done_steps[r] == rs.steps:
            self._finish_host(app, host)

    def _finish_host(self, app: int, host: int) -> None:
        sim = self.sim
        rs = self.ring[app]
        r = rs.rank[host]
        ok = all(rs.chunk_vals[r][c] == sim.expected_total(app, c)
                 for c in range(rs.p))
        if not ok:
            sim.mismatches += 1
        flags = sim.have[(app, host)]
        newly = 0
        for b in range(sim.blocks[app]):
            if not flags[b]:
                flags[b] = 1
                newly += 1
        remaining = sim.app_remaining[app] - newly
        sim.app_remaining[app] = remaining
        sim.completed_blocks += newly
        if remaining == 0:
            sim.job_finished(app)
