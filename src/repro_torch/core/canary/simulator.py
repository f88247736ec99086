"""Packet-level discrete-event simulator facade for in-network allreduce (§5.2).

The simulator is layered (see ``ARCHITECTURE.md``); this module only wires
the layers together and exposes the stable public API:

* :mod:`~.engine`    — event heap, clock, dispatch.
* :mod:`~.topology`  — link fabric + routing (``fat_tree``/``three_tier``/...).
* :mod:`~.switch`    — switch dataplane + the algorithm-strategy registry
                       (``CANARY``, ``STATIC_TREE``; ``RING`` registers from
                       :mod:`~.hostproto`).
* :mod:`~.hostproto` — host send pump, leader role, loss recovery.
* :mod:`~.workloads` — background congestion + sender-noise models.

Every packet carries an exact integer payload; at the end of a run the
simulator asserts that every participant received the true sum for every
block, under any combination of congestion, stragglers, collisions, drops and
switch failures. A run is therefore both a performance measurement and an
end-to-end correctness proof of the protocol implementation.

Hot-path wiring (ARCHITECTURE.md §Performance): construction ends with a
*finalize* pass — every layer pre-resolves the callables it dispatches to per
packet, the topology binds the engine's ``push`` directly, and ``run`` hands
the engine a pre-resolved handler table indexed by event kind. ``all_done``
is O(1) via the ``apps_active`` counter, and per-app constants (leader maps,
expected totals, packet sizes) are precomputed at job setup so no hot path
re-derives them per packet.
"""
from __future__ import annotations

import gc
import random
from typing import Dict, List, Optional, Set, Tuple

from . import network as _network  # noqa: F401  (registers "fat_tree")
from .engine import (EV_ARRIVE_HOST, EV_ARRIVE_SWITCH, EV_FAIL_SWITCH,
                     EV_FAULT, EV_GBN_TIMER, EV_HEAL, EV_JOB_ARRIVE,
                     EV_LEADER_DONE, EV_LINK_ARRIVE_HOST,
                     EV_LINK_ARRIVE_SWITCH, EV_PFC_PAUSE, EV_PFC_RESUME,
                     EV_PUMP, EV_RATE_TIMER, EV_RETX, EV_TELEMETRY_PROBE,
                     EV_TIMER, EventLoop, N_EVENT_KINDS)
from .hostproto import HostProtocol
from .switch import SwitchLayer, make_strategy
from .topology import make_topology
from .types import (Algo, AllreduceJob, Packet, PacketPool, SimConfig,
                    SimResult)
from .workloads import CongestionWorkload

_CONTRIB_MULT = 1000003


def contribution(app: int, block: int, host: int) -> int:
    """Deterministic integer contribution of ``host`` to ``(app, block)``."""
    return (host + 1) * _CONTRIB_MULT + 31 * block + 7919 * app


class Simulator:
    """One simulation run. Construct, then call :meth:`run` once."""

    def __init__(self, cfg: SimConfig, jobs: List[AllreduceJob],
                 algo: Algo = Algo.CANARY, n_trees: int = 1,
                 noise_hosts: Optional[List[int]] = None,
                 admission=None):
        cfg.validate()
        self.cfg = cfg
        self.jobs = {j.app: j for j in jobs}
        try:
            self.algo = Algo(algo)
        except ValueError:
            self.algo = str(algo)  # strategy registered under a custom key
        self.n_trees = n_trees
        self.net = make_topology(cfg)
        self.rng = random.Random(cfg.seed)
        self.engine = EventLoop()
        self.pool = PacketPool()
        # hot-path drop state (tx_to_* in topology.py): the RNG is drawn
        # only when drop_prob > 0, exactly like maybe_drop()
        self._drop_prob = cfg.drop_prob
        self._rng_random = self.rng.random

        # opt-in aggregation-provenance recording (repro.core.trace). The
        # recorder is observation-only: every layer guards its hook calls
        # with ``sim.trace is not None`` and the hooks touch no protocol
        # state, so traced runs replay the goldens bit-for-bit.
        self.trace = None
        if cfg.trace:
            from ..trace.recorder import TraceRecorder  # deferred: optional
            self.trace = TraceRecorder(self)

        # layers (construction order matters: strategies touch hostproto)
        self.switch = SwitchLayer(self, self.net.num_switches)
        self.hostproto = HostProtocol(self, cfg.num_hosts)
        self.workload = CongestionWorkload(self, noise_hosts)
        # transport policy (repro.core.transport): None under the default
        # "none", so every hook site reduces to one identity check. Deferred
        # import — the transport package imports canary modules, never the
        # other way around, and the core import graph stays jax-free.
        self.transport = None
        if cfg.transport and cfg.transport != "none":
            from ..transport import make_transport
            self.transport = make_transport(cfg.transport, self)
        self.strategy = make_strategy(self.algo, self)
        # opt-in telemetry (repro.core.telemetry): the same observation-only
        # deal as the trace recorder — ``None`` when off, so every layer
        # hook site is one guarded identity check, and on-runs replay the
        # goldens bit-for-bit (probe ticks are outside the events count).
        # Built AFTER the layers on purpose: the hub's own object graph
        # (registry, per-link series, span state) must not interleave with
        # the hot layer structures on the heap — layers resolve it in their
        # finalize step, never at construction.
        self.telemetry = None
        if cfg.telemetry:
            from ..telemetry.hub import Telemetry  # deferred: optional
            self.telemetry = Telemetry(self)
        # opt-in fault injection (repro.core.faults): same deal — ``None``
        # without a schedule, so the hot-layer hooks stay one identity check
        # (or one float compare against the link poison horizon) and
        # fault-free runs replay the goldens bit-for-bit. Built before the
        # finalize pass so hostproto can bind it.
        self.faults = None
        if cfg.faults:
            from ..faults import FaultSchedule  # deferred: optional
            self.faults = FaultSchedule(self)
        # finalize: every layer pre-resolves its per-packet callables now
        # that the full layer graph exists (ARCHITECTURE.md §Performance)
        self.switch.finalize()
        self.hostproto.finalize()
        self.net.bind(self)
        if self.transport is not None:
            self.transport.finalize()
        if self.telemetry is not None:
            self.telemetry.finalize()

        # multi-tenant fleet state (repro.core.fleet). With no admission
        # controller everything below stays empty and the dataplane behaves
        # exactly as before — the fleet layer is pay-for-what-you-use.
        self.admission = admission
        self.tenant_of: Dict[int, int] = {}            # app -> tenant
        self.slot_regions: Dict[int, Tuple[int, int]] = {}  # app -> (offset, size)
        self.bypass_apps: Set[int] = set()             # degraded: host-based §3.3 path
        self.job_submit_ns: Dict[int, float] = {}
        self.job_start_ns: Dict[int, float] = {}
        self.app_fallback_blocks: Dict[int, int] = {}
        if admission is not None:
            admission.attach(self)

        # completion tracking. ``apps_active`` counts apps with unfinished
        # blocks so ``all_done`` is O(1) — it is decremented exactly once
        # per app (in job_finished, or at activation for degenerate
        # single-participant jobs).
        self.have: Dict[Tuple[int, int], bytearray] = {}
        self.app_remaining: Dict[int, int] = {}
        self.app_done_ns: Dict[int, float] = {}
        self.apps_active = 0
        self.mismatches = 0

        # counters (mutated by the layers)
        self.stragglers = 0
        self.collisions = 0
        self.restorations = 0
        self.retransmissions = 0
        self.fallbacks = 0
        self.dropped = 0
        self.dropped_failed = 0  # subset of ``dropped``: failed-switch sink
        self.completed_blocks = 0

        # per-job precomputation (hot-path constants; see _setup_jobs)
        self.blocks: Dict[int, int] = {}
        self.leaders: Dict[int, List[int]] = {}
        self.partset: Dict[int, Set[int]] = {}
        self.contrib_sum_base: Dict[int, Tuple[int, int]] = {}
        self.nparts: Dict[int, int] = {}               # len(participants)
        self.pkt_bytes: Dict[int, int] = {}            # REDUCE wire size
        self._leader_fixed: Dict[int, int] = {}        # reduce/broadcast root
        self._contrib_root: Dict[int, int] = {}        # broadcast source
        self._barrier_apps: Set[int] = set()
        self._et_base: Dict[int, int] = {}             # expected_total =
        self._et_slope: Dict[int, int] = {}            #   base + slope * block
        self._setup_jobs()
        if self.faults is not None:
            self.faults.start()

    # ------------------------------------------------------------------ setup
    def _setup_jobs(self) -> None:
        cfg = self.cfg
        for app, job in self.jobs.items():
            parts = sorted(job.participants)
            if len(set(parts)) != len(parts):
                raise ValueError(f"duplicate participants in app {app}")
            B = job.num_blocks(cfg.payload_bytes)
            self.blocks[app] = B
            self.partset[app] = set(parts)
            self.leaders[app] = parts
            self.nparts[app] = len(parts)
            self.tenant_of[app] = job.tenant if job.tenant >= 0 else app
            s1 = sum(h + 1 for h in parts)
            self.contrib_sum_base[app] = (s1, len(parts))
            self.job_submit_ns[app] = max(0.0, job.arrival_ns)
            # hot-path constants: leader map, wire size, expected totals
            coll = job.collective
            if coll in ("reduce", "broadcast"):
                root = job.root if job.root is not None else parts[0]
                self._leader_fixed[app] = root
            self.pkt_bytes[app] = cfg.header_bytes + 8 \
                if coll == "barrier" else cfg.mtu_bytes
            if coll == "barrier":
                self._barrier_apps.add(app)
                self._et_base[app] = 0
                self._et_slope[app] = 0
            elif coll == "broadcast":
                root = self._leader_fixed[app]
                self._contrib_root[app] = root
                self._et_base[app] = (root + 1) * _CONTRIB_MULT + 7919 * app
                self._et_slope[app] = 31
            else:
                p = len(parts)
                self._et_base[app] = _CONTRIB_MULT * s1 + p * 7919 * app
                self._et_slope[app] = 31 * p
            # completion tracking is registered up front for every job —
            # including ones that arrive later — so ``all_done`` keeps the
            # engine running until open-loop arrivals have completed too.
            if coll == "reduce":
                root = self._leader_fixed[app]
                self.have[(app, root)] = bytearray(B)
                self.app_remaining[app] = B
            else:
                for h in parts:
                    self.have[(app, h)] = bytearray(B)
                self.app_remaining[app] = len(parts) * B
            self.apps_active += 1
            if job.arrival_ns > 0.0:
                self.engine.push(job.arrival_ns, EV_JOB_ARRIVE, app, 0, None)
            else:
                self._activate_job(app)
        self.workload.start()
        if cfg.switch_fail_ns is not None and cfg.failed_switch is not None:
            self.engine.push(cfg.switch_fail_ns, EV_FAIL_SWITCH,
                             cfg.failed_switch, 0, None)

    def _activate_job(self, app: int) -> None:
        """Start ``app``'s protocol: at construction (t=0 jobs), when its
        ``EV_JOB_ARRIVE`` fires, or when the admission controller retries a
        deferred job after capacity frees up."""
        job = self.jobs[app]
        parts = self.leaders[app]
        B = self.blocks[app]
        if len(parts) == 1:
            # degenerate single-participant collective: already reduced
            h = parts[0]
            flags = self.have[(app, h)]
            for b in range(B):
                flags[b] = 1
            self.app_remaining[app] = 0
            self.apps_active -= 1
            if self.apps_active == 0:
                self.engine.stop = True
            self.completed_blocks += B
            self.job_start_ns[app] = self.now
            self.app_done_ns[app] = self.now
            return
        if self.admission is not None:
            decision = self.admission.on_job_arrival(self, app, job)
            if decision == "defer":
                return  # retried via on_job_done when a slot frees up
            if decision == "degrade":
                # quota exhausted: the whole job rides the §3.3 host-based
                # path (bypass packets, leader unicasts the result)
                self.bypass_apps.add(app)
                self.app_fallback_blocks[app] = B
        self.job_start_ns[app] = self.now
        self.strategy.setup_job(app, job, parts)

    def job_finished(self, app: int) -> None:
        """All of ``app``'s blocks completed: stamp the finish time and give
        the admission controller its quota slots back."""
        self.apps_active -= 1
        if self.apps_active == 0:
            self.engine.stop = True  # loop breaks before the next dispatch
        self.app_done_ns[app] = self.now
        if self.admission is not None:
            self.admission.on_job_done(self, app)

    # ------------------------------------------------------------- protocol
    def expected_total(self, app: int, block: int) -> int:
        # precomputed affine form of the original per-call derivation; see
        # _setup_jobs (barrier: 0; broadcast: the root's contribution;
        # allreduce/reduce: MULT*s1 + p*(31*block + 7919*app))
        return self._et_base[app] + self._et_slope[app] * block

    def leader_of(self, app: int, block: int) -> int:
        root = self._leader_fixed.get(app)
        if root is not None:
            return root
        parts = self.leaders[app]
        return parts[block % len(parts)]

    def contribution_of(self, app: int, block: int, host: int) -> int:
        if app in self._barrier_apps:
            return 0
        root = self._contrib_root.get(app)
        if root is not None:  # broadcast: only the source contributes
            return contribution(app, block, root) if host == root else 0
        return contribution(app, block, host)

    # ----------------------------------------------- hooks used by the layers
    @property
    def now(self) -> float:
        return self.engine.now

    @property
    def events(self) -> int:
        return self.engine.events

    @property
    def tables(self):
        """Per-switch descriptor tables (compat accessor; state lives in the
        switch layer)."""
        return self.switch.tables

    def maybe_drop(self) -> bool:
        return self._drop_prob > 0.0 and self._rng_random() < self._drop_prob

    def arrive_switch(self, t: float, sw: int, port: int, pkt: Packet) -> None:
        self.engine.push(t, EV_ARRIVE_SWITCH, sw, port, pkt)

    def arrive_host(self, t: float, host: int, pkt: Packet) -> None:
        self.engine.push(t, EV_ARRIVE_HOST, host, 0, pkt)

    def all_done(self) -> bool:
        return self.apps_active == 0

    # -------------------------------------------------------------------- run
    def _handle_fail_switch(self, a: int, b: int, c: object) -> None:
        self.switch.fail_switch(a)

    def _handle_job_arrive(self, a: int, b: int, c: object) -> None:
        self._activate_job(a)

    def run(self) -> SimResult:
        cfg = self.cfg
        # pre-resolved handler table, indexed by event kind (engine.run
        # dispatches via one list index + call per event)
        handlers = [None] * N_EVENT_KINDS
        handlers[EV_ARRIVE_SWITCH] = self.switch.arrive
        handlers[EV_ARRIVE_HOST] = self.hostproto.handle_arrive
        # staged link arrivals dispatch to the same layer entry points (the
        # engine unwraps the Link's FIFO head into the packet argument)
        handlers[EV_LINK_ARRIVE_SWITCH] = self.switch.arrive
        handlers[EV_LINK_ARRIVE_HOST] = self.hostproto.handle_arrive
        handlers[EV_TIMER] = self.switch.on_timer
        handlers[EV_PUMP] = self.hostproto.handle_pump
        handlers[EV_RETX] = self.hostproto.handle_retx
        handlers[EV_FAIL_SWITCH] = self._handle_fail_switch
        handlers[EV_LEADER_DONE] = self.hostproto.handle_leader_done
        handlers[EV_JOB_ARRIVE] = self._handle_job_arrive
        tp = self.transport
        if tp is not None:
            handlers[EV_PFC_PAUSE] = tp.handle_pfc_pause
            handlers[EV_PFC_RESUME] = tp.handle_pfc_resume
            handlers[EV_RATE_TIMER] = tp.handle_rate_timer
            handlers[EV_GBN_TIMER] = tp.handle_gbn_timer
        tel = self.telemetry
        if tel is not None:
            handlers[EV_TELEMETRY_PROBE] = tel.handle_probe
            tel.start()  # arm the self-re-arming probe chain
        fa = self.faults
        if fa is not None:
            handlers[EV_FAULT] = fa.handle_fault
            handlers[EV_HEAL] = fa.handle_heal
        # the event loop allocates millions of short-lived tuples/packets and
        # creates no reference cycles; pausing the cyclic GC for the drain is
        # worth ~10-15% wall time (state restored on every exit path)
        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        self.engine.stop = self.all_done()
        try:
            self.engine.run(handlers, cfg.max_events)
            if tel is not None:
                # freezes exact summary totals. Cheap by design
                # (O(counters + one pass over the flush log)); the closing
                # probe sample and the heavy span/instant decode defer to
                # the first reader of tel.spans/instants/registry (see
                # hub docstring)
                tel.finish()
        finally:
            if gc_was_enabled:
                gc.enable()
        end = max(self.app_done_ns.values()) if self.app_done_ns else self.now
        utils = self.net.utilizations(end if end > 0 else 1.0)
        goodput = {}
        for app, job in self.jobs.items():
            # JCT, not absolute finish: identical for t=0 jobs, and the only
            # meaningful denominator for open-loop (late-arriving) jobs
            dur = self.app_done_ns.get(app, self.now) - self.job_submit_ns[app]
            goodput[app] = (job.data_bytes * 8.0) / dur if dur > 0 else 0.0
        maxdesc = max(self.switch.desc_high) if self.switch.desc_high else 0
        # per-cause drop split + transport telemetry (additive SimResult
        # fields: the golden contract pins only the pre-existing ones)
        tele = self.transport.telemetry() if self.transport is not None else {}
        host_rates = tele.pop("host_rate_gbps", {})
        fault_dropped = sum(fa.drop_counts.values()) if fa is not None else 0
        drop_causes = {
            "wire": self.dropped - self.dropped_failed - fault_dropped,
            "switch_fail": self.dropped_failed}
        if fa is not None:
            # fault drops merge by cause ("switch_fail" folds into the
            # failed-switch sink; "link_down" is its own bucket)
            for cause, n in fa.drop_counts.items():
                drop_causes[cause] = drop_causes.get(cause, 0) + n
            fault_exposure, fault_recovery, survived = fa.finish()
        else:
            fault_exposure = fault_recovery = survived = {}
        if "gbn_ooo" in tele:
            drop_causes["gbn_ooo_discard"] = tele["gbn_ooo"]
        return SimResult(
            duration_ns=end,
            start_ns=0.0,
            goodput_gbps=goodput,
            correct=(self.mismatches == 0 and self.all_done()),
            link_utilization=utils,
            avg_utilization=sum(utils) / len(utils) if utils else 0.0,
            stragglers=self.stragglers,
            collisions=self.collisions,
            restorations=self.restorations,
            retransmissions=self.retransmissions,
            fallbacks=self.fallbacks,
            max_descriptors_per_switch=maxdesc,
            max_descriptor_bytes=maxdesc * cfg.mtu_bytes,
            events=self.events,
            dropped_packets=self.dropped,
            completed_blocks=self.completed_blocks,
            job_submit_ns=dict(self.job_submit_ns),
            job_start_ns=dict(self.job_start_ns),
            job_finish_ns=dict(self.app_done_ns),
            job_admitted={a: a not in self.bypass_apps for a in self.jobs},
            app_fallback_blocks=dict(self.app_fallback_blocks),
            tenant_of=dict(self.tenant_of),
            transport=str(cfg.transport),
            drop_causes=drop_causes,
            transport_stats=tele,
            host_rate_gbps=host_rates,
            telemetry_summary=(tel.summary_dict() if tel is not None else {}),
            fault_events=(list(fa.events) if fa is not None else []),
            fault_exposure_ns=fault_exposure,
            fault_recovery_ns=fault_recovery,
            survived=survived,
        )
