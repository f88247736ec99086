"""Transport-policy contract (see ``ARCHITECTURE.md`` §Transport).

A :class:`TransportPolicy` is the endpoint + fabric reaction layer the core
protocol stack deliberately omits: loss recovery beyond the whole-block
``EV_RETX`` timer, congestion signalling (ECN/CNP) and congestion response
(rate control, PFC pause). The canary layers call a fixed set of hooks at
their natural choke points; every hook site is guarded by a single
``transport is not None`` identity check, so the default ``none`` policy
(represented as ``None``, never an object) leaves the golden event streams
bit-identical.

Hook map (caller -> hook):

* ``hostproto.handle_pump``  -> :meth:`before_send` / :meth:`after_send`
* ``hostproto.handle_arrive``-> :meth:`on_receive`
* ``topology.tx_*`` (every egress serialize) -> :meth:`on_egress`
* strategy cursor walk / FAIL resend -> :meth:`on_block_sent`
* ``hostproto.complete_at_host`` -> :meth:`on_block_complete`
* engine events ``EV_PFC_PAUSE``/``EV_PFC_RESUME``/``EV_RATE_TIMER``/
  ``EV_GBN_TIMER`` -> the ``handle_*`` methods (wired by the facade's
  handler table).

``before_send`` is the only hook with a non-trivial return protocol: None
lets the packet go out; :data:`TX_PAUSED` parks it (the policy must re-pump
on its resume event); :data:`TX_ABSORBED` transfers packet ownership to the
policy; a float parks it until that release time (rate pacing).

Policies needing randomness must draw from their **own** ``random.Random``
stream, never ``sim.rng`` — the core RNG's draw sequence is pinned by the
golden contract.
"""
from __future__ import annotations

from typing import Dict

from ..canary.hostproto import TX_ABSORBED, TX_PAUSED

__all__ = ["TransportPolicy", "TX_PAUSED", "TX_ABSORBED"]


class TransportPolicy:
    """Base policy: every hook is a no-op pass-through.

    Subclasses register with :func:`repro.core.transport.register_transport`
    and are constructed by the facade as ``cls(sim)`` after the switch,
    hostproto and workload layers exist (the strategy does not yet);
    :meth:`finalize` runs after the whole layer graph is bound.
    """

    name = "base"
    # True when the policy replaces the per-block EV_RETX timers with its own
    # recovery (go-back-N): strategies then report sends via on_block_sent
    # instead of arming timers, and FAIL resends bypass plan-driven fabrics.
    owns_block_retx = False

    def __init__(self, sim):
        self.sim = sim
        self.cfg = sim.cfg

    def finalize(self) -> None:
        """Called once by the facade after all layers are bound."""

    # ---- host send path ---------------------------------------------------
    def before_send(self, host: int, pkt) -> object:
        """Gate a packet about to leave ``host``'s NIC. Return None to send,
        TX_PAUSED / TX_ABSORBED / a float release time otherwise."""
        return None

    def after_send(self, host: int, pkt, nic_free: float) -> float:
        """Observe a completed send; return the next pump time (>= the
        NIC-free time for pure observation, later to pace the host)."""
        return nic_free

    # ---- host receive path ------------------------------------------------
    def on_receive(self, host: int, pkt):
        """First look at every host arrival. Return the packet to hand it to
        the protocol stack, or None after consuming (and recycling) it."""
        return pkt

    # ---- fabric egress ----------------------------------------------------
    def on_egress(self, link, pkt, qdelay_ns: float) -> None:
        """Observe a packet serialized onto ``link`` with ``qdelay_ns`` of
        queue ahead of its arrival (backlog bytes = qdelay_ns *
        link.bytes_per_ns, this packet included). ECN marking and PFC
        watermark checks live here."""

    # ---- block-level reliability (owns_block_retx policies) ----------------
    def on_block_sent(self, host: int, app: int, block: int) -> None:
        """A host sent its REDUCE contribution for ``block``."""

    def on_block_complete(self, host: int, app: int, block: int) -> None:
        """``host`` completed ``block`` (result delivered and verified)."""

    # ---- engine event handlers ---------------------------------------------
    def handle_pfc_pause(self, a: int, b: int, c: object) -> None:
        pass

    def handle_pfc_resume(self, a: int, b: int, c: object) -> None:
        pass

    def handle_rate_timer(self, a: int, b: int, c: object) -> None:
        pass

    def handle_gbn_timer(self, a: int, b: int, c: object) -> None:
        pass

    # ---- telemetry ---------------------------------------------------------
    def telemetry(self) -> Dict[str, object]:
        """Counters for ``SimResult.transport_stats``. The special key
        ``host_rate_gbps`` (dict host -> Gb/s) is split out by the facade."""
        return {}
