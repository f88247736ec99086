"""DCQCN-style congestion control: RED/ECN marking, CNPs, rate control, PFC.

The policy models the RoCEv2 congestion-control stack the NetReduce line of
work assumes underneath in-network reduction:

* **RED/ECN at egress** (:meth:`on_egress`): every serialize onto a link
  observes the backlog ahead of the packet; the mark probability ramps
  linearly from 0 at ``ecn_kmin_bytes`` to ``ecn_pmax`` at ``ecn_kmax_bytes``
  and is 1 above. Marks use the policy's **own** RNG stream — the core RNG's
  draw sequence is pinned by the golden contract.
* **CNP notification** (:meth:`on_receive`): a receiver seeing an ECN mark
  sends at most one CNP per ``cnp_interval_ns`` per (receiver, sender) pair.
  CNP/ACK control packets are modelled as a lossless priority class: they
  are never paced, paused, or marked.
* **DCQCN rate machine**: on CNP, ``target = rate; rate *= 1 - alpha/2;
  alpha = (1-g)*alpha + g; stage = 0`` and the rate-increase timer is armed.
  Each ``dcqcn_timer_ns`` tick decays alpha, runs fast recovery
  (``rate = (rate+target)/2``) for ``dcqcn_f`` stages and then additive
  increase (``target += dcqcn_rai_gbps``), snapping back to (and disarming
  at) line rate. The current rate paces the host pump via inter-packet gaps
  (``before_send`` returning a float release time).
* **PFC priority pause**: crossing ``pfc_pause_bytes`` of backlog pauses the
  *culprit sender* (a deliberate simplification of per-ingress-port pause —
  the simulator has no per-port ingress queues to backpressure): an
  ``EV_PFC_PAUSE`` lands one hop latency later, and the matching
  ``EV_PFC_RESUME`` is scheduled at the closed-form drain time of the
  backlog down to ``pfc_resume_bytes``. Deeper crossings supersede earlier
  resumes (``pause_until`` max-tracking; stale resumes carry their scheduled
  time and are dropped on mismatch).
"""
from __future__ import annotations

import random
from typing import Dict

from ..canary.engine import EV_PFC_PAUSE, EV_PFC_RESUME, EV_RATE_TIMER
from ..canary.types import PacketKind
from . import register_transport
from .base import TX_PAUSED, TransportPolicy

_K_CNP = int(PacketKind.CNP)  # CNP/ACK: the lossless control class (>= CNP)


class _HostCC:
    """Per-host DCQCN sender state."""

    __slots__ = ("rate", "target", "alpha", "stage", "timer_epoch",
                 "timer_armed", "next_free", "paused", "pause_pending",
                 "pause_until", "pause_start")

    def __init__(self, line_rate: float) -> None:
        self.rate = line_rate    # current send rate, bytes/ns
        self.target = line_rate
        self.alpha = 1.0
        self.stage = 0
        self.timer_epoch = 0
        self.timer_armed = False
        self.next_free = 0.0     # pacing: earliest next transmission
        self.paused = False      # PFC pause in effect
        self.pause_pending = False
        self.pause_until = 0.0   # latest scheduled resume time
        self.pause_start = 0.0


@register_transport("dcqcn")
class Dcqcn(TransportPolicy):
    """ECN marking + CNPs + DCQCN rate control + PFC pause."""

    def __init__(self, sim):
        super().__init__(sim)
        cfg = sim.cfg
        self._engine = sim.engine
        self._push = sim.engine.push
        self._push_timer = sim.engine.push_timer
        self._pool = sim.pool
        self._pool_free = sim.pool.free
        self._hp = sim.hostproto
        # policy-private RNG: the core stream's draw order is golden-pinned
        self._rng = random.Random(cfg.seed ^ 0x5DEECE66D)
        self._line = cfg.bytes_per_ns
        self._kmin = float(cfg.ecn_kmin_bytes)
        self._kmax = float(cfg.ecn_kmax_bytes)
        self._pmax = cfg.ecn_pmax
        span = self._kmax - self._kmin
        self._ramp = self._pmax / span if span > 0 else 0.0
        self._cnp_gap = cfg.cnp_interval_ns
        self._g = cfg.dcqcn_g
        self._rai = cfg.dcqcn_rai_gbps / 8.0          # Gb/s -> bytes/ns
        self._timer_ns = cfg.dcqcn_timer_ns
        self._min_rate = cfg.dcqcn_min_rate_gbps / 8.0
        self._fstages = cfg.dcqcn_f
        self._xoff = float(cfg.pfc_pause_bytes)
        self._xon = float(cfg.pfc_resume_bytes)
        self._cc = [_HostCC(self._line) for _ in range(cfg.num_hosts)]
        self._telemetry = None  # observation-only; bound in finalize()
        self._last_cnp: Dict[tuple, float] = {}  # (receiver, sender) -> t
        self._cnp_bytes = cfg.header_bytes + 8
        self.ecn_marks = 0
        self.cnps = 0
        self.rate_cuts = 0
        self.pfc_pauses = 0
        self.pfc_pause_ns = 0.0

    def finalize(self) -> None:
        # the telemetry hub is constructed after the transport layer
        self._telemetry = self.sim.telemetry

    # ------------------------------------------------------------ send path
    def before_send(self, host: int, pkt):
        if pkt.kind >= _K_CNP:
            return None  # control class: never paused or paced
        st = self._cc[host]
        if st.paused:
            return TX_PAUSED  # resume event re-pumps
        if st.rate >= self._line:
            return None
        nf = st.next_free
        if nf > self._engine.now:
            return nf  # paced: hold until the inter-packet gap elapses
        return None

    def after_send(self, host: int, pkt, nic_free: float) -> float:
        st = self._cc[host]
        if st.rate >= self._line or pkt.kind >= _K_CNP:
            return nic_free
        now = self._engine.now
        base = st.next_free if st.next_free > now else now
        st.next_free = nf = base + pkt.size_bytes / st.rate
        return nf if nf > nic_free else nic_free

    # ---------------------------------------------------------- fabric egress
    def on_egress(self, link, pkt, qdelay_ns: float) -> None:
        backlog = qdelay_ns * link.bytes_per_ns
        kind = pkt.kind
        if backlog > self._kmin and kind < _K_CNP and not pkt.ecn:
            # RED ramp; >= Kmax marks deterministically
            if backlog >= self._kmax \
                    or self._rng.random() < (backlog - self._kmin) * self._ramp:
                pkt.ecn = True
                self.ecn_marks += 1
        if backlog >= self._xoff and pkt.src >= 0 and kind < _K_CNP:
            st = self._cc[pkt.src]
            now = self._engine.now
            lat = link.latency_ns
            resume_t = now + (backlog - self._xon) / link.bytes_per_ns + lat
            if resume_t > st.pause_until:
                if not st.pause_pending and not st.paused:
                    st.pause_pending = True
                    self._push(now + lat, EV_PFC_PAUSE, pkt.src, 0, None)
                st.pause_until = resume_t
                self._push(resume_t, EV_PFC_RESUME, pkt.src, 0, resume_t)

    # --------------------------------------------------------- receive path
    def on_receive(self, host: int, pkt):
        kind = pkt.kind
        if kind == _K_CNP:
            self._rate_cut(host)
            self._pool_free(pkt)
            return None
        if pkt.ecn and pkt.src >= 0 and kind < _K_CNP:
            key = (host, pkt.src)
            now = self._engine.now
            if now - self._last_cnp.get(key, -1e18) >= self._cnp_gap:
                self._last_cnp[key] = now
                cnp = self._pool.alloc()
                cnp.kind = PacketKind.CNP
                cnp.dest = pkt.src
                cnp.id = 0
                cnp.value = 0
                cnp.size_bytes = self._cnp_bytes
                cnp.src = host
                self._hp.hosts[host].queue.append(cnp)
                self._hp.schedule_pump(host, now)
                self.cnps += 1
                if self._telemetry is not None:
                    self._telemetry.on_cnp(host, pkt.src)
        return pkt

    # ------------------------------------------------------- DCQCN rate logic
    def _rate_cut(self, host: int) -> None:
        st = self._cc[host]
        st.target = st.rate
        st.rate *= 1.0 - st.alpha / 2.0
        if st.rate < self._min_rate:
            st.rate = self._min_rate
        st.alpha = (1.0 - self._g) * st.alpha + self._g
        st.stage = 0
        self.rate_cuts += 1
        if not st.timer_armed:
            st.timer_armed = True
            st.timer_epoch += 1
            self._push_timer(self._engine.now + self._timer_ns, EV_RATE_TIMER,
                             host, 0, st.timer_epoch)

    def handle_rate_timer(self, a: int, b: int, c: object) -> None:
        st = self._cc[a]
        if c != st.timer_epoch or not st.timer_armed:
            return  # lazily-cancelled stale timer
        st.alpha *= 1.0 - self._g
        st.stage += 1
        if st.stage > self._fstages:
            st.target += self._rai  # additive increase past fast recovery
            if st.target > self._line:
                st.target = self._line
        st.rate = (st.rate + st.target) / 2.0  # fast recovery toward target
        if st.rate >= 0.999 * self._line:
            st.rate = self._line
            st.timer_armed = False
            return
        st.timer_epoch += 1
        self._push_timer(self._engine.now + self._timer_ns, EV_RATE_TIMER,
                         a, 0, st.timer_epoch)

    # ----------------------------------------------------------- PFC events
    def handle_pfc_pause(self, a: int, b: int, c: object) -> None:
        st = self._cc[a]
        st.pause_pending = False
        if not st.paused:
            st.paused = True
            st.pause_start = self._engine.now
            self.pfc_pauses += 1
            if self._telemetry is not None:
                self._telemetry.on_pfc(a, True)

    def handle_pfc_resume(self, a: int, b: int, c: object) -> None:
        st = self._cc[a]
        if c < st.pause_until:
            return  # superseded by a deeper later crossing
        if st.paused:
            st.paused = False
            self.pfc_pause_ns += self._engine.now - st.pause_start
            self._hp.schedule_pump(a, self._engine.now)
            if self._telemetry is not None:
                self._telemetry.on_pfc(a, False)
        st.pause_pending = False

    # ------------------------------------------------------------- telemetry
    def telemetry(self):
        now = self._engine.now
        pause_ns = self.pfc_pause_ns
        rates = {}
        for h, st in enumerate(self._cc):
            if st.paused:  # residual: run ended mid-pause
                pause_ns += now - st.pause_start
            if st.rate < self._line:
                rates[h] = st.rate * 8.0  # bytes/ns -> Gb/s
        return {"ecn_marks": float(self.ecn_marks),
                "cnps": float(self.cnps),
                "rate_cuts": float(self.rate_cuts),
                "pfc_pauses": float(self.pfc_pauses),
                "pfc_pause_ns": pause_ns,
                "host_rate_gbps": rates}
