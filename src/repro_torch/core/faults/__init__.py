"""Fault injection: mid-run failures as scheduled engine events.

The seed simulator could only fail a switch *statically* (``switch_fail_ns``
pushes one ``EV_FAIL_SWITCH`` before the run starts, and the switch never
recovers). This package turns failure into a first-class, schedulable event
stream: ``SimConfig(faults=[...])`` builds a :class:`FaultSchedule` that
injects ``EV_FAULT`` / ``EV_HEAL`` events (engine kinds 15/16, dispatched in
the uncounted orchestration band, so the golden ``events`` field never moves)
at the configured times.

Registered fault kinds (string-keyed, like transports and backends)::

    {"kind": "switch_crash", "target": 5, "at_ns": 2e3, "heal_ns": 5e4}
    {"kind": "link_down",    "target": "leaf0->spine3", "at_ns": ..., "heal_ns": ...}
    {"kind": "link_degrade", "target": 17, "factor": 0.1, "at_ns": ..., "heal_ns": ...}
    {"kind": "link_flap",    "target": ..., "at_ns": ..., "down_ns": ...,
                             "period_ns": ..., "cycles": 4}
    {"kind": "host_slow",    "target": 9, "at_ns": ..., "heal_ns": ...}

Specs are FLAT, JSON-able dicts so sweep work items survive the
``asdict -> SimConfig(**cfg)`` round trip. Link targets are either an index
into ``Topology.all_links()`` or a name from ``Topology.link_names()``.

Failure model
-------------
* **switch_crash** marks the switch failed AND flushes its dataplane
  (descriptor table, slot map, armed timers — the SRAM is gone), then
  poisons every link *into* the switch so traffic stops being offered to it.
  Packets already in flight still arrive and drop at the failed-switch check
  (charged to ``switch_fail``, exactly like the legacy path). Healing
  un-poisons the links and lets the switch admit descriptors again.
* **link_down** poisons the link (``busy_until`` = ``LINK_DOWN_HORIZON``,
  see ``topology.py``) and *drains its staged-arrival FIFO*: everything
  behind the head is popped and charged as dropped; the head entry — which
  owns the link's armed heap entry — is neutralized in place (packet slot
  set to ``None``; the engine skips such pops), preserving the
  one-heap-entry-per-busy-link invariant.
* **link_degrade** scales ``bytes_per_ns`` by ``factor`` (already-queued
  serialization commitments keep their old timestamps — only new sends see
  the degraded rate), restoring the original rate on heal.
* **link_flap** is link_down on a timer: down for ``down_ns`` out of every
  ``period_ns``, ``cycles`` times.
* **host_slow** parks the host's send pump (the straggler model §5.2.5, but
  scheduled and recoverable); the heal re-pumps it.

Graceful degradation contract
-----------------------------
LB policies treat poisoned links as infinite backlog and route around them
(including the ECMP/flowlet fast paths — a dead group member is removed, as
on real switches). A block that exhausts ``max_generations`` while a fault
is live escalates its whole app to the §3.3 host-based fallback
(:meth:`FaultSchedule.escalate_app`): bypass packets, no switch memory, and
the app's quota slot is released so deferred jobs can re-admit. With the
``gbn`` transport every reduction stays *exact* under any fault schedule —
the survivability tests pin this invariant; without it, losses are measured
(``drop_causes``), never hidden.

Everything here is pay-for-what-you-use: no schedule -> ``Simulator.faults``
is ``None`` and every hook site in the hot layers reduces to one guarded
identity check (or one float compare against the poison horizon on an
already-loaded ``busy_until``) — the goldens replay bit-for-bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Type

from ..canary.engine import EV_FAULT, EV_HEAL
from ..canary.topology import LINK_DOWN_HORIZON, Link

__all__ = ["Fault", "FaultSchedule", "FAULTS", "register_fault"]


class Fault:
    """One scheduled failure. Subclasses implement :meth:`apply` /
    :meth:`heal`; the schedule owns timing and bookkeeping."""

    kind: str = ""

    def __init__(self, schedule: "FaultSchedule", spec: dict):
        self.schedule = schedule
        self.spec = spec
        self.target = spec.get("target")
        self.at_ns = float(spec["at_ns"])
        heal = spec.get("heal_ns")
        self.heal_ns: Optional[float] = None if heal is None else float(heal)
        if self.heal_ns is not None and self.heal_ns <= self.at_ns:
            raise ValueError(f"{self.kind}: heal_ns must be > at_ns ({spec})")

    def apply(self, sim) -> None:
        raise NotImplementedError

    def heal(self, sim) -> None:
        raise NotImplementedError

    # flaps override: the next EV_FAULT time after a heal, or None
    def next_cycle_ns(self, now: float) -> Optional[float]:
        return None


FAULTS: Dict[str, Type[Fault]] = {}


def register_fault(name: str):
    """Class decorator: make a fault kind selectable via spec dicts."""

    def deco(cls: Type[Fault]) -> Type[Fault]:
        cls.kind = name
        FAULTS[name] = cls
        return cls

    return deco


class _LinkFaultMixin:
    """Shared link-target resolution (index or link_names() name)."""

    def resolve_link(self, sim) -> Tuple[Link, int]:
        net = sim.net
        t = self.target
        if isinstance(t, str):
            names = net.link_names()
            try:
                idx = names.index(t)
            except ValueError:
                raise ValueError(
                    f"{self.kind}: unknown link name {t!r}") from None
        else:
            idx = int(t)
        links = net.all_links()
        if not 0 <= idx < len(links):
            raise ValueError(f"{self.kind}: link index {idx} out of range "
                             f"(fabric has {len(links)} links)")
        return links[idx], idx


@register_fault("switch_crash")
class SwitchCrash(Fault):
    """Crash + (optional) recovery of one switch."""

    def __init__(self, schedule, spec):
        super().__init__(schedule, spec)
        self._poisoned: List[Link] = []

    def apply(self, sim) -> None:
        sw = int(self.target)
        if not 0 <= sw < sim.net.num_switches:
            raise ValueError(f"switch_crash: switch {sw} out of range")
        sim.switch.crash_switch(sw)
        sched = self.schedule
        self._poisoned = []
        for link in sim.net.links_into(sw):
            if sched.poison(link, "switch_fail", sw):
                self._poisoned.append(link)

    def heal(self, sim) -> None:
        sim.switch.heal_switch(int(self.target))
        sched = self.schedule
        for link in self._poisoned:
            sched.unpoison(link)
        self._poisoned = []


@register_fault("link_down")
class LinkDown(Fault, _LinkFaultMixin):
    def __init__(self, schedule, spec):
        super().__init__(schedule, spec)
        self._link: Optional[Link] = None

    def apply(self, sim) -> None:
        link, _ = self.resolve_link(sim)
        # claim the link only if we poisoned it — under overlapping faults
        # the first claimant's heal revives it
        self._link = link if self.schedule.poison(link, "link_down", -1) \
            else None

    def heal(self, sim) -> None:
        if self._link is not None:
            self.schedule.unpoison(self._link)
            self._link = None


@register_fault("link_degrade")
class LinkDegrade(Fault, _LinkFaultMixin):
    """Bandwidth brown-out: scale the link rate by ``factor`` (0 < f < 1)."""

    def __init__(self, schedule, spec):
        super().__init__(schedule, spec)
        self.factor = float(spec.get("factor", 0.1))
        if not 0.0 < self.factor < 1.0:
            raise ValueError("link_degrade: factor must be in (0, 1)")
        self._link: Optional[Link] = None
        self._orig = 0.0

    def apply(self, sim) -> None:
        link, _ = self.resolve_link(sim)
        self._link = link
        self._orig = link.bytes_per_ns
        link.bytes_per_ns = self._orig * self.factor

    def heal(self, sim) -> None:
        if self._link is not None:
            self._link.bytes_per_ns = self._orig
            self._link = None


@register_fault("link_flap")
class LinkFlap(LinkDown):
    """link_down on a duty cycle: down ``down_ns`` out of every
    ``period_ns``, ``cycles`` times (heal_ns is derived, not given)."""

    def __init__(self, schedule, spec):
        spec = dict(spec)
        self.down_ns = float(spec.get("down_ns", 0.0))
        self.period_ns = float(spec.get("period_ns", 0.0))
        self.cycles = int(spec.get("cycles", 1))
        if not (0.0 < self.down_ns < self.period_ns):
            raise ValueError("link_flap needs 0 < down_ns < period_ns")
        if self.cycles < 1:
            raise ValueError("link_flap needs cycles >= 1")
        spec["heal_ns"] = float(spec["at_ns"]) + self.down_ns
        super().__init__(schedule, spec)
        self._cycles_left = self.cycles

    def next_cycle_ns(self, now: float) -> Optional[float]:
        self._cycles_left -= 1
        if self._cycles_left <= 0:
            return None
        # next down edge: one period after the previous one
        nxt = self.at_ns + self.period_ns
        self.at_ns = nxt
        self.heal_ns = nxt + self.down_ns
        return nxt


@register_fault("host_slow")
class HostSlow(Fault):
    """A recoverable straggler: the host's pump is parked until the heal."""

    def apply(self, sim) -> None:
        host = int(self.target)
        if not 0 <= host < sim.cfg.num_hosts:
            raise ValueError(f"host_slow: host {host} out of range")
        self.schedule.paused_hosts.add(host)

    def heal(self, sim) -> None:
        host = int(self.target)
        self.schedule.paused_hosts.discard(host)
        sim.hostproto.schedule_pump(host, sim.now)


class FaultSchedule:
    """Owns the run's fault set: injects the events, poisons/heals links,
    charges fault drops by cause, and computes survivability metrics."""

    def __init__(self, sim):
        self.sim = sim
        self.faults: List[Fault] = []
        for spec in sim.cfg.faults:
            try:
                cls = FAULTS[spec["kind"]]
            except KeyError:
                raise ValueError(
                    f"unknown fault kind {spec.get('kind')!r}; "
                    f"registered: {sorted(FAULTS)}") from None
            self.faults.append(cls(self, spec))
        # Link -> drop cause while poisoned (Links hash by identity)
        self._down: Dict[Link, str] = {}
        self._where: Dict[Link, int] = {}
        self.drop_counts: Dict[str, int] = {}
        self.paused_hosts: set = set()
        self.events: List[dict] = []          # flat fault/heal/escalate log
        self.escalated: set = set()
        self._n_active = 0
        # fault-active windows: [start, end]; end is None while open
        self._windows: List[List[Optional[float]]] = []
        self._open: Dict[int, int] = {}       # fault idx -> window idx

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Arm the schedule (called by the facade after job setup)."""
        sim = self.sim
        sim.hostproto._fault_paused = self.paused_hosts
        for i, f in enumerate(self.faults):
            sim.engine.push(f.at_ns, EV_FAULT, i, 0, self)

    def handle_fault(self, a: int, _b: int, _c: object) -> None:
        sim = self.sim
        f = self.faults[a]
        f.apply(sim)
        now = sim.now
        self._n_active += 1
        self._open[a] = len(self._windows)
        self._windows.append([now, None])
        self.events.append(dict(kind=f.kind, target=f.target, t_ns=now,
                                phase="fault"))
        tel = sim.telemetry
        if tel is not None:
            tel.on_fault(f.kind, f.target, True)
        if f.heal_ns is not None:
            sim.engine.push(f.heal_ns, EV_HEAL, a, 0, self)

    def handle_heal(self, a: int, _b: int, _c: object) -> None:
        sim = self.sim
        f = self.faults[a]
        f.heal(sim)
        now = sim.now
        self._n_active -= 1
        w = self._open.pop(a, None)
        if w is not None:
            self._windows[w][1] = now
        self.events.append(dict(kind=f.kind, target=f.target, t_ns=now,
                                phase="heal"))
        tel = sim.telemetry
        if tel is not None:
            tel.on_fault(f.kind, f.target, False)
        nxt = f.next_cycle_ns(now)
        if nxt is not None:
            sim.engine.push(nxt, EV_FAULT, a, 0, self)

    def any_active(self) -> bool:
        return self._n_active > 0

    # --------------------------------------------------------- link poisoning
    def poison(self, link: Link, cause: str, where: int) -> bool:
        """Mark ``link`` dead and drain its staged FIFO. Returns False when
        the link is already poisoned (by an overlapping fault) — the caller
        must then not claim it for healing."""
        if link in self._down:
            return False
        self._down[link] = cause
        self._where[link] = where
        link.busy_until = LINK_DOWN_HORIZON
        q = link.inflight
        if q:
            # everything behind the head is dropped outright; the head owns
            # the link's armed heap entry, so it is neutralized in place and
            # the engine skips its (packet-less) pop
            while len(q) > 1:
                entry = q.pop()
                if entry[2] is not None:
                    self._charge(entry[2], cause, where)
            head = q[0]
            if head[2] is not None:
                q[0] = (head[0], head[1], None)
                self._charge(head[2], cause, where)
        return True

    def unpoison(self, link: Link) -> None:
        if self._down.pop(link, None) is None:
            return
        self._where.pop(link, None)
        # the backlog that existed at fault time was dropped; the healed
        # link comes back idle
        link.busy_until = self.sim.now

    def on_tx_down(self, link: Link, pkt, where: int) -> None:
        """A send was offered to a poisoned link (tx hot paths detect the
        horizon on the already-loaded ``busy_until`` and call here)."""
        self._charge(pkt, self._down.get(link, "link_down"),
                     self._where.get(link, where))

    def _charge(self, pkt, cause: str, where: int) -> None:
        sim = self.sim
        sim.dropped += 1
        self.drop_counts[cause] = self.drop_counts.get(cause, 0) + 1
        tel = sim.telemetry
        if tel is not None:
            tel.on_drop(cause, where)
        if not pkt.multicast:
            sim.pool.free(pkt)

    # ------------------------------------------------------------- degradation
    def escalate_app(self, app: int) -> None:
        """Generation-cap escalation (§3.3): flip ``app`` to the host-based
        fallback mid-run. Later blocks send bypass packets (no switch
        memory), the strategy's cached per-app constants are rebuilt, and
        the app's quota slot is released for deferred jobs."""
        sim = self.sim
        if app in sim.bypass_apps:
            return
        sim.bypass_apps.add(app)
        self.escalated.add(app)
        inv = getattr(sim.strategy, "invalidate_send_cache", None)
        if inv is not None:
            inv(app)
        if sim.admission is not None:
            sim.admission.release(sim, app)
        self.events.append(dict(kind="escalate", target=app, t_ns=sim.now,
                                phase="escalate"))

    # ------------------------------------------------------------ end of run
    def _union(self, t_end: float) -> List[Tuple[float, float]]:
        spans = sorted((s, e if e is not None else t_end)
                       for s, e in self._windows)
        out: List[List[float]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1][1] = e
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def finish(self) -> Tuple[Dict[int, float], Dict[int, float],
                              Dict[int, bool]]:
        """Per-app survivability metrics: fault exposure, recovery tail and
        survival (see the ``SimResult`` field docs)."""
        sim = self.sim
        t_end = sim.now
        union = self._union(t_end)
        exposure: Dict[int, float] = {}
        recovery: Dict[int, float] = {}
        survived: Dict[int, bool] = {}
        for app in sim.jobs:
            start = sim.job_start_ns.get(app, sim.job_submit_ns.get(app, 0.0))
            done = sim.app_done_ns.get(app)
            survived[app] = done is not None
            fin = done if done is not None else t_end
            exp = 0.0
            last_heal = None
            for s, e in union:
                lo, hi = max(s, start), min(e, fin)
                if hi > lo:
                    exp += hi - lo
                    if e <= fin and (last_heal is None or e > last_heal):
                        last_heal = e
            exposure[app] = exp
            recovery[app] = max(0.0, fin - last_heal) \
                if last_heal is not None else 0.0
        return exposure, recovery, survived
