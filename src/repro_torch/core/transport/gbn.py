"""Go-back-N transport policy: sequenced flows + block re-request flows.

Replaces the core's bare whole-block ``EV_RETX`` timer with NetReduce-style
go-back-N recovery, at two granularities:

* **Packet flows** — point-to-point sequenced traffic (the RING collective's
  per-neighbor streams). Each ``(sender, dest)`` flow stamps per-packet
  sequence numbers at first transmission, keeps an in-window ``unacked``
  snapshot map for retransmission, absorbs window overflow into a ``stalled``
  queue (so one stalled flow never blocks the host's other traffic), and
  runs a single per-flow timeout that retransmits the whole outstanding
  window in order — classic go-back-N. Receivers deliver strictly in order,
  discard anything else (counted in ``gbn_ooo``), and answer with cumulative
  ACKs (every ``gbn_ack_every`` deliveries, plus an immediate duplicate ACK
  on each discard so the sender re-syncs quickly).

* **Block flows** — the aggregated collectives (CANARY/STATIC_TREE), where
  a "flow" toward the leader is consumed in-network and per-packet sequencing
  is meaningless. Each ``(host, app)`` flow tracks the set of sent-but-
  incomplete blocks and re-requests up to ``gbn_window`` of them per
  ``retx_timeout_ns`` round via :meth:`HostProtocol.gbn_request_block` —
  superseding both EV_RETX arm sites (the cursor walk and the FAIL resend).

Both flow kinds share ``EV_GBN_TIMER`` (payload ``(tag, key, epoch)``,
lazy-cancelled by epoch mismatch: one live heap entry per armed flow).
No randomness is used, so runs stay deterministic per seed.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Set, Tuple

from ..canary.engine import EV_GBN_TIMER
from ..canary.types import Packet, PacketKind
from . import register_transport
from .base import TX_ABSORBED, TransportPolicy

_K_RING = int(PacketKind.RING)
_K_ACK = int(PacketKind.ACK)


class _PktFlow:
    """Sender-side go-back-N state for one (host, dest) sequenced flow."""

    __slots__ = ("base", "next_seq", "unacked", "stalled", "epoch",
                 "timer_armed")

    def __init__(self) -> None:
        self.base = 0       # lowest unacknowledged sequence number
        self.next_seq = 0   # next sequence number to stamp
        # seq -> (dest, value, size_bytes, chunk, step, id) retx snapshot
        self.unacked: Dict[int, tuple] = {}
        self.stalled: Deque[Packet] = deque()  # window-overflow, FIFO by seq
        self.epoch = 0      # lazy timer cancellation
        self.timer_armed = False


class _BlockFlow:
    """Per-(host, app) set of sent-but-incomplete blocks to re-request."""

    __slots__ = ("outstanding", "epoch", "timer_armed")

    def __init__(self) -> None:
        self.outstanding: Set[int] = set()
        self.epoch = 0
        self.timer_armed = False


@register_transport("gbn")
class GoBackN(TransportPolicy):
    """Go-back-N recovery for both sequenced and aggregated flows."""

    owns_block_retx = True

    def __init__(self, sim):
        super().__init__(sim)
        cfg = sim.cfg
        self._engine = sim.engine
        self._push_timer = sim.engine.push_timer
        self._pool = sim.pool
        self._pool_free = sim.pool.free
        self._hp = sim.hostproto
        self._window = cfg.gbn_window
        self._timeout = cfg.gbn_timeout_ns
        self._block_timeout = cfg.retx_timeout_ns
        self._ack_every = cfg.gbn_ack_every
        self._ack_bytes = cfg.header_bytes + 8
        self._telemetry = None  # observation-only; bound in finalize()
        self._flows: Dict[Tuple[int, int], _PktFlow] = {}
        self._bflows: Dict[Tuple[int, int], _BlockFlow] = {}
        self._expected: Dict[Tuple[int, int], int] = {}  # (host, src) -> seq
        self._ack_due: Dict[Tuple[int, int], int] = {}
        self.gbn_retx = 0
        self.gbn_acks = 0
        self.gbn_ooo = 0

    def finalize(self) -> None:
        # the telemetry hub is constructed after the transport layer
        self._telemetry = self.sim.telemetry

    # ------------------------------------------------------------ send path
    def before_send(self, host: int, pkt):
        if pkt.kind != _K_RING:
            return None  # only sequenced point-to-point traffic is windowed
        key = (host, pkt.dest)
        f = self._flows.get(key)
        if f is None:
            f = self._flows[key] = _PktFlow()
        seq = pkt.seq
        if seq < 0:
            pkt.seq = seq = f.next_seq
            f.next_seq = seq + 1
        elif seq in f.unacked:
            return None  # timeout retransmission of a live packet
        elif seq < f.base:
            # stale retx clone raced the cumulative ACK: already delivered
            self._pool_free(pkt)
            return TX_ABSORBED
        # first transmission (fresh stamp, or released from the stall queue)
        if f.stalled or seq >= f.base + self._window:
            f.stalled.append(pkt)
            return TX_ABSORBED
        f.unacked[seq] = (pkt.dest, pkt.value, pkt.size_bytes, pkt.chunk,
                          pkt.step, pkt.id)
        if not f.timer_armed:
            f.timer_armed = True
            f.epoch += 1
            self._push_timer(self._engine.now + self._timeout, EV_GBN_TIMER,
                             host, 0, ("p", pkt.dest, f.epoch))
        return None

    # --------------------------------------------------------- receive path
    def on_receive(self, host: int, pkt):
        kind = pkt.kind
        if kind == _K_ACK:
            self.gbn_acks += 1
            self._process_ack(host, pkt)
            self._pool_free(pkt)
            return None
        if kind == _K_RING:
            seq = pkt.seq
            if seq < 0:
                return pkt  # unsequenced (pre-policy traffic): deliver as-is
            key = (host, pkt.src)
            exp = self._expected.get(key, 0)
            if seq == exp:
                self._expected[key] = exp + 1
                self._maybe_ack(host, pkt.src, exp)
                return pkt
            # out of order: a gap after a loss, or a duplicate behind the
            # cursor — go-back-N receivers discard both, and the immediate
            # duplicate cumulative ACK re-syncs the sender's window
            self.gbn_ooo += 1
            if self._telemetry is not None:
                self._telemetry.on_gbn("ooo", host, 1)
            if exp > 0:
                self._send_ack(host, pkt.src, exp - 1)
            self._pool_free(pkt)
            return None
        return pkt

    def _process_ack(self, host: int, pkt) -> None:
        f = self._flows.get((host, pkt.src))
        if f is None:
            return
        cum = pkt.seq
        if cum < f.base:
            return  # duplicate ACK behind the window base
        unacked = f.unacked
        for s in range(f.base, cum + 1):
            unacked.pop(s, None)
        f.base = cum + 1
        # window slid: release stalled packets back into the send queue
        stalled = f.stalled
        limit = f.base + self._window
        released = False
        if stalled:
            hq = self._hp.hosts[host].queue
            while stalled and stalled[0].seq < limit:
                hq.append(stalled.popleft())
                released = True
        if not unacked and not stalled:
            f.epoch += 1  # lazy-cancel the flow timer: nothing outstanding
            f.timer_armed = False
        if released:
            self._hp.schedule_pump(host, self._engine.now)

    def _maybe_ack(self, host: int, src: int, cum: int) -> None:
        key = (host, src)
        due = self._ack_due.get(key, 0) + 1
        if due >= self._ack_every:
            self._ack_due[key] = 0
            self._send_ack(host, src, cum)
        else:
            self._ack_due[key] = due

    def _send_ack(self, host: int, src: int, cum: int) -> None:
        ack = self._pool.alloc()
        ack.kind = PacketKind.ACK
        ack.dest = src
        ack.id = 0
        ack.value = 0
        ack.size_bytes = self._ack_bytes
        ack.src = host
        ack.seq = cum
        self._hp.hosts[host].queue.append(ack)
        self._hp.schedule_pump(host, self._engine.now)

    # ------------------------------------------------------------ block flows
    def on_block_sent(self, host: int, app: int, block: int) -> None:
        sim = self.sim
        if sim.have.get((app, host)) is None:
            # pure contributor (reduce collective): nothing to wait for here;
            # the root's own block flow drives any recovery
            return
        key = (host, app)
        bf = self._bflows.get(key)
        if bf is None:
            bf = self._bflows[key] = _BlockFlow()
        bf.outstanding.add(block)
        if not bf.timer_armed:
            bf.timer_armed = True
            bf.epoch += 1
            self._push_timer(self._engine.now + self._block_timeout,
                             EV_GBN_TIMER, host, 0, ("b", app, bf.epoch))

    def on_block_complete(self, host: int, app: int, block: int) -> None:
        bf = self._bflows.get((host, app))
        if bf is None:
            return
        bf.outstanding.discard(block)
        if not bf.outstanding:
            bf.epoch += 1  # lazy-cancel the armed timer
            bf.timer_armed = False

    # ---------------------------------------------------------------- timers
    def handle_gbn_timer(self, a: int, b: int, c: object) -> None:
        tag, key, epoch = c
        if tag == "p":
            f = self._flows.get((a, key))
            if f is None or epoch != f.epoch:
                return  # lazily cancelled
            if not f.unacked:
                f.timer_armed = False
                return
            # go-back-N: retransmit the whole outstanding window in order
            hq = self._hp.hosts[a].queue
            alloc = self._pool.alloc
            for s in sorted(f.unacked):
                dest, value, size, chunk, step, pid = f.unacked[s]
                pkt = alloc()
                pkt.kind = PacketKind.RING
                pkt.dest = dest
                pkt.id = pid
                pkt.value = value
                pkt.size_bytes = size
                pkt.src = a
                pkt.chunk = chunk
                pkt.step = step
                pkt.seq = s
                hq.append(pkt)
                self.gbn_retx += 1
            if self._telemetry is not None:
                self._telemetry.on_gbn("retx", a, len(f.unacked))
            self._push_timer(self._engine.now + self._timeout, EV_GBN_TIMER,
                             a, 0, ("p", key, epoch))
            self._hp.schedule_pump(a, self._engine.now)
            return
        # tag == "b": block re-request round
        bf = self._bflows.get((a, key))
        if bf is None or epoch != bf.epoch:
            return
        sim = self.sim
        flags = sim.have.get((key, a))
        if flags is not None:
            done = [blk for blk in bf.outstanding if flags[blk]]
            for blk in done:
                bf.outstanding.discard(blk)
        if not bf.outstanding or sim.apps_active == 0:
            bf.timer_armed = False
            return
        for blk in sorted(bf.outstanding)[:self._window]:
            self._hp.gbn_request_block(a, key, blk)
        self._push_timer(self._engine.now + self._block_timeout, EV_GBN_TIMER,
                         a, 0, ("b", key, bf.epoch))

    # ------------------------------------------------------------- telemetry
    def telemetry(self):
        return {"gbn_retx": float(self.gbn_retx),
                "gbn_acks": float(self.gbn_acks),
                "gbn_ooo": float(self.gbn_ooo)}
