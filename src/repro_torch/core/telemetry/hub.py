"""The Telemetry hub: probes, spans and instants for one simulation run.

Contract (mirrors the trace recorder, see ARCHITECTURE.md §Telemetry):

* **Off = no object.** ``Simulator.telemetry`` is ``None`` unless
  ``SimConfig.telemetry`` is set; every hook site in the layers is one
  guarded ``if self._telemetry is not None`` identity check, so the off
  path costs nothing measurable.
* **Observation-only.** No hook draws from ``sim.rng``, schedules a
  protocol event, or mutates layer state. The periodic probe rides its own
  engine event kind (``EV_TELEMETRY_PROBE``) which the run loop dispatches
  *outside* the golden ``events`` count — telemetry-on runs replay every
  golden bit-for-bit, including the event counter.
* **No packet retention.** Hooks read packet/descriptor fields during the
  call and keep only plain numbers — the packet pool recycles objects, so
  holding a reference would alias a future packet.
* **Cheap when on.** Hooks run once per protocol event in the hottest
  loops, so they do no string formatting: spans and instants are appended
  as small raw tuples (first element = type tag) and only rendered into
  names/args by the exporters; per-switch series and histograms are
  pre-resolved at :meth:`finalize`; the per-descriptor sites are inlined
  into the switch layer as plain appends/compares against hub-owned state
  (no bound-method call). The perf suite pins the on-overhead budget
  (``benchmarks.perf.TELEMETRY_BUDGET``).
* **Lazy consolidation.** The run itself only collects raw logs and
  counters; :meth:`finish` (called at the end of ``Simulator.run``) does
  O(counters + one pass over the flush log) bookkeeping so
  ``SimResult.telemetry_summary`` is exact, and everything heavier —
  decoding descriptor spans, merging the per-packet instant log, replaying
  histograms, snapshotting run metadata — runs at most once, the first
  time a reader touches ``spans``, ``instants``, ``registry``, ``meta`` or
  ``open_blocks``. A sweep that never reads its telemetry never pays for
  consolidation. One semantic consequence: when the span cap binds,
  lifecycle (block/bcast) spans recorded during the run take priority, and
  descriptor spans merge afterwards in flush order — the drop *totals*
  stay exact either way.

Two data planes:

* **Probes** (``telemetry_probes``): every ``telemetry_probe_ns`` of sim
  time, sample per-link queue backlog, per-switch descriptor-table
  occupancy (the series are sampled; the per-switch *high-water* gauge is
  event-driven at on_desc_alloc and therefore exact at any cadence — see
  ``desc_high_water``), per-host DCQCN pacing rate, transport counter rates
  (ECN marks, CNPs, PFC pauses, go-back-N retx) and per-app outstanding
  block count. Series are delta-encoded (see ``metrics.TimeSeries``).
* **Spans** (``telemetry_spans``): block lifecycle (first REDUCE send ->
  last participant completion, with the leader-done -> completion broadcast
  tail as a nested span), per-descriptor aggregation windows (alloc ->
  timeout/complete flush), and instant events for drops, collisions,
  stragglers, retransmissions, CNPs and PFC pause/resume.

Span tuples (exporters render these — keep in sync with ``export.py``):

* ``("block", app, block, t0, t1, last_host)``
* ``("bcast", app, block, t0, t1)``
* ``("desc", sw, app, block, reason, merges, children, t0, t1)``

Instant tuples:

* ``("leader_done", app, block, leader, t)``
* ``("collision"|"straggler", sw, app, block, t)`` — the hot hooks log the
  raw packed packet id and the app/block decode happens once, lazily, at
  consolidation
* ``("drop", cause, where, t)``
* ``("retx", what, app, host, block, t)``
* ``("cnp", dst, src, t)``
* ``("pfc", host, paused, t)``
* ``("gbn", what, host, count, t)``
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..canary.engine import EV_TELEMETRY_PROBE
from ..canary.types import APP_SHIFT, GEN_BITS
from .metrics import MetricsRegistry

__all__ = ["Telemetry"]

# generation-free block key: (app << _APP_BITS_SHIFT) | block — the same
# packing as Packet.id >> GEN_BITS, so on_host_send computes it with one shift
_APP_BITS_SHIFT = APP_SHIFT - GEN_BITS
_BLOCK_MASK = (1 << _APP_BITS_SHIFT) - 1


class Telemetry:
    """Per-run telemetry hub. Constructed by the facade when
    ``cfg.telemetry`` is set; :meth:`finalize` runs after all layers bind."""

    def __init__(self, sim) -> None:
        self.sim = sim
        cfg = sim.cfg
        self.cfg = cfg
        self.probe_ns = float(cfg.telemetry_probe_ns)
        self._registry = MetricsRegistry(
            series_cap=cfg.telemetry_max_samples)
        self.probes = 0
        self.spans_dropped = 0
        self._probes_on = bool(cfg.telemetry_probes)
        self._spans_on = bool(cfg.telemetry_spans)
        self._max_spans = int(cfg.telemetry_max_spans)
        self._max_pkt = min(int(cfg.telemetry_max_pkt_instants),
                            self._max_spans)
        self._engine = sim.engine
        # raw span/instant tuples (see module docstring for the shapes).
        # ``_spans``/``_instants`` back the lazy ``spans``/``instants``
        # properties; per-packet instants (stragglers/collisions) and
        # descriptor flushes collect in their own raw logs and merge in at
        # consolidation
        self._spans: List[Tuple] = []
        self._instants: List[Tuple] = []
        self._pkt_instants: List[Tuple] = []
        self._desc_log: List[Tuple] = []  # appended inline by switch.py
        # lazy-consolidation state: finish() freezes the exact totals the
        # summary needs, _consolidate() does the heavy decode on first read
        self._finished = False
        self._consolidated = False
        self._desc_merged = 0  # full desc-log entries that fit the cap
        self._pkt_merged = 0   # pkt instants that fit the cap
        self.spans_total = 0
        self.instants_total = 0
        self._final_now = 0.0  # engine time at finish(), for the closing
        self._summary = None   # sample + meta snapshot at consolidation
        # plain attribute counters for the per-event hooks (surfaced by
        # summary_dict; string-keyed registry counters are for rare events)
        self.desc_allocs = 0
        self.flush_timeout = 0
        self.flush_complete = 0
        self.blocks_started = 0
        self.blocks_completed = 0
        # set from the sim's own exact totals at finish(); the hooks never
        # count these (they fire per packet — the sim already counts them)
        self.collisions = 0
        self.stragglers = 0
        # hot-path gates, mirrored INTO the layers as pre-bound site state
        # (strategy._tel_open / strategy._tel_pkt / hostproto._tel_left, see
        # start()) so each hot site pays one attribute load + identity check;
        # want_sends drops when every block has opened (the hub retracts
        # the site attribute), want_pkt_instants when the per-packet
        # instant log caps out (that site retracts itself) — either way
        # the site then goes fully cold
        self.want_sends = self._spans_on
        self.want_completes = self._spans_on
        self.want_pkt_instants = self._spans_on and self._max_pkt > 0
        # open block-lifecycle state, keyed (app << _APP_BITS_SHIFT) | block.
        # ``block_open`` and ``block_left`` are PUBLIC: the two hottest call
        # sites inline their common-case check/decrement against them and
        # only call into the hub on the rare interesting transition (first
        # send of a block, last completion of a block) — see
        # AggregationStrategy.next_host_packet and
        # HostProtocol.complete_at_host.
        self.block_open: Dict[int, float] = {}
        self._leader_done_t: Dict[int, float] = {}
        self.block_left: Dict[int, List[int]] = {}  # filled in start()
        self._strategy = None  # site owner for _tel_open/_tel_pkt (start())
        # pre-created histograms, fed from raw value lists the hot hooks
        # append to; consolidation replays the lists into the buckets
        self._lat_hist = self._registry.hist("block/latency_ns")
        self._win_hist = self._registry.hist("desc/window_ns")
        self._lat_vals: List[float] = []
        self._win_vals: List[float] = []
        # bound in finalize()
        self._links: List = []
        self._link_ts: List = []
        self._tables: List[dict] = []
        self._sw_ts: List = []
        self._sw_hi: List[int] = []
        self._total_blocks = -1  # set in start(); -1 = never triggers swap
        self._tp = None
        self._tp_last: Dict[str, float] = {}
        self.occupancy_model_bytes = 0.0
        self.occupancy_model_descriptors = 0.0
        # span finalization (filled lazily by _consolidate(); consumed by
        # the diagnosis layer, see analysis.view_of): run metadata snapshot
        # and the blocks still open when the run ended (budget abort /
        # deferred job) — the attribution must never mistake a truncated
        # lifecycle for a fast one
        self._meta: Dict[str, object] = None
        self._open_blocks: List[Tuple[int, int, float, float]] = None

    # ------------------------------------------------------------- lifecycle
    def finalize(self) -> None:
        """Pre-resolve probe targets now that the layer graph exists, and
        install the pre-bound descriptor hooks into the strategy (the hub is
        constructed after the layers, so the strategy cannot bind them at
        its own construction)."""
        sim = self.sim
        strat = sim.strategy
        strat._telemetry = self
        reg = self._registry
        self._links = list(sim.net.all_links())
        self._link_ts = [reg.ts(f"link/{i}/backlog_bytes")
                         for i in range(len(self._links))]
        self._tables = sim.switch.tables
        # event-driven per-switch occupancy: series + exact high-waters
        self._sw_ts = [reg.ts(f"switch/{i}/descriptors")
                       for i in range(len(self._tables))]
        self._sw_hi = [0] * len(self._tables)
        # install the inlined per-descriptor site state (see switch.py):
        # the alloc site maxes into the hub's own high-water list and the
        # flush site appends into the hub's own raw log, so the hot path
        # pays a few loads instead of a bound-method call
        strat._tel_sw_hi = self._sw_hi
        strat._tel_desc_log = self._desc_log
        strat._tel_desc_cap = self._max_spans if self._spans_on else 0
        self._tp = sim.transport
        # the §3.2.2 analytic occupancy bound the probed series compares to
        from ..canary.memory_model import model_for
        model = model_for(self.cfg)
        self.occupancy_model_bytes = float(model.occupancy_bytes)
        self.occupancy_model_descriptors = float(
            model.occupancy_bytes / self.cfg.mtu_bytes)

    def start(self) -> None:
        """Arm the probe chain (called once from ``Simulator.run``, after the
        per-app participant maps exist — ``finalize`` runs too early)."""
        sim = self.sim
        # per-app flat countdown arrays: block_left[app][block] holds how
        # many participant completions remain before the block span closes —
        # the call site decrements inline and only calls on_block_complete
        # when a block's count hits zero
        self.block_left = {}
        total_blocks = 0
        for app, left in sim.app_remaining.items():
            npart = sim.nparts[app]
            if sim.jobs[app].collective == "reduce":
                blocks, init = left, 1
            else:
                blocks, init = left // npart, npart
            self.block_left[app] = [init] * blocks
            total_blocks += blocks
        # total distinct blocks across apps: once every one has opened,
        # want_sends drops and the send site goes cold
        self._total_blocks = total_blocks
        if total_blocks == 0:
            self.want_sends = False
        # install the pre-bound site state in the layers: each hot site then
        # gates on ONE instance attribute (dict-or-None / list-or-None)
        # that is retracted when the site stops being interesting
        strat = self._strategy = sim.strategy
        strat._tel_open = self.block_open if self.want_sends else None
        strat._tel_pkt = \
            self._pkt_instants if self.want_pkt_instants else None
        strat._tel_pkt_cap = self._max_pkt
        sim.hostproto._tel_left = \
            self.block_left if self.want_completes else None
        if self._probes_on:
            self._engine.push(self._engine.now, EV_TELEMETRY_PROBE, 0, 0, None)

    def handle_probe(self, a: int, b: int, c: object) -> None:
        """Engine handler for EV_TELEMETRY_PROBE: sample, then re-arm one
        cadence ahead — unless the run is over (stop flag) or this probe is
        the only thing left queued (both heaps empty after the pop)."""
        eng = self._engine
        now = eng.now
        self.probes += 1
        self._sample(now)
        if not eng.stop and (eng.heap or eng.timer_heap):
            eng.push(now + self.probe_ns, EV_TELEMETRY_PROBE, 0, 0, None)

    def finish(self) -> None:
        """End-of-run bookkeeping, called from ``Simulator.run`` before the
        result is built — deliberately cheap (O(counters) plus one pass
        over the raw flush log), so the timed run never pays for
        consolidation: it syncs the descriptor counters from the inlined
        call sites and freezes the exact span/instant/drop totals
        ``summary_dict`` reports. Everything heavier — the closing probe
        sample, the series-extrema sync, the decode/merge/replay work — is
        deferred to :meth:`_consolidate`, which the ``spans``/``instants``/
        ``registry``/``meta``/``open_blocks`` properties trigger on first
        read. Only the engine clock is captured here, so the deferred
        closing sample lands at the run's true end time."""
        self._final_now = self._engine.now
        # collision/straggler totals come from the simulator's own counters
        # (incremented at the exact same call sites, telemetry or not) —
        # the hooks only log instants, so the hub never double-counts
        self.collisions = int(self.sim.collisions)
        self.stragglers = int(self.sim.stragglers)
        # descriptor counters from the inlined call sites (see switch.py):
        # allocs are a plain int on the strategy; flush reasons take one
        # pass over the raw log (full entries carry the reason at [2],
        # slim past-the-cap entries at [0])
        strat = self._strategy if self._strategy is not None \
            else self.sim.strategy
        self.desc_allocs = int(getattr(strat, "_tel_desc_n", 0))
        log = self._desc_log
        full = 0
        timeouts = 0
        for e in log:
            if len(e) == 5:
                full += 1
                if e[2] == "timeout":
                    timeouts += 1
            elif e[0] == "timeout":
                timeouts += 1
        self.flush_timeout = timeouts
        self.flush_complete = len(log) - timeouts
        # exact truncation/merge arithmetic, shared with _consolidate():
        # the summary totals must agree bit-for-bit with the consolidated
        # lists without forcing the consolidation. Cap priority: lifecycle
        # spans recorded during the run land first, descriptor spans merge
        # into the remaining room in flush order; the per-packet instant
        # log merges into the instants' remaining room. Every offered span
        # either lands or counts in spans_dropped — never silent.
        if self._spans_on:
            self._desc_merged = min(
                full, max(0, self._max_spans - len(self._spans)))
            self.spans_dropped += \
                (full - self._desc_merged) + (len(log) - full)
            recorded = len(self._pkt_instants)
            self.spans_dropped += \
                self.stragglers + self.collisions - recorded
            room = self._max_spans - len(self._instants)
            self._pkt_merged = min(recorded, room) if room > 0 else 0
            self.spans_dropped += recorded - self._pkt_merged
        self.spans_total = len(self._spans) + self._desc_merged
        self.instants_total = len(self._instants) + self._pkt_merged
        self._finished = True

    def _consolidate(self) -> None:
        """One-time heavy consolidation, lazily triggered by the first
        reader after :meth:`finish`: take the closing probe sample (the
        probe chain dies with the heaps, so without it the series could end
        one cadence before the final completions drained — the layers are
        inert after the run, so sampling them late reads the same state),
        raise the sampled per-switch series extrema to the exact
        event-driven gauges, decode the raw descriptor-flush log into
        ``("desc", ...)`` span tuples and the window histogram, merge and
        decode the per-packet instant log, replay the block-latency
        values, record the blocks still open when the run ended and
        snapshot the run metadata for the diagnosis layer. A run whose
        telemetry is never read never pays for any of this."""
        self._consolidated = True
        if self._probes_on:
            self._sample(self._final_now)
        # raise each sampled per-switch series' hi to the exact event-driven
        # gauge (a probe can land between an alloc and its flush and miss
        # the true peak)
        for hi, ts in zip(self._sw_hi, self._sw_ts):
            if ts.t and hi > ts.hi:
                ts.hi = float(hi)
        log = self._desc_log
        if self._spans_on:
            left = self._desc_merged
            if left:
                spans = self._spans
                for e in log:
                    if len(e) == 5:
                        # the raw record retains the descriptor itself;
                        # id/counter/alloc_ns are frozen at flush (only the
                        # children set keeps mutating, hence the captured
                        # count), so the decode reads them off the object
                        sw, d, reason, children, t1 = e
                        pid = d.id
                        spans.append(("desc", sw, pid >> APP_SHIFT,
                                      (pid >> GEN_BITS) & _BLOCK_MASK,
                                      reason, d.counter, children,
                                      d.alloc_ns, t1))
                        left -= 1
                        if left == 0:
                            break
            if self._pkt_merged:
                # decode the raw packed ids into the documented
                # ("collision"|"straggler", sw, app, block, t) shape —
                # once per kept entry, off the hot path
                self._instants.extend(
                    (kind, sw, pid >> APP_SHIFT,
                     (pid >> GEN_BITS) & _BLOCK_MASK, t)
                    for kind, sw, pid, t in
                    self._pkt_instants[:self._pkt_merged])
            self._pkt_instants = []
        # histogram replay: window durations come from the flush log (full
        # entries carry the retained descriptor and the flush time, slim
        # entries the duration itself), block latencies from the raw list
        self._win_vals.extend(
            (e[4] - e[1].alloc_ns) if len(e) == 5 else e[1] for e in log)
        self._desc_log = []
        self._win_hist.observe_many(self._win_vals)
        self._win_vals.clear()
        self._lat_hist.observe_many(self._lat_vals)
        self._lat_vals.clear()
        # blocks still open at end of run keep an explicit
        # truncated-lifecycle record, and the run metadata the attribution
        # needs to interpret spans without the live simulator is
        # snapshotted once, in the cold path
        now = self._engine.now
        self._open_blocks = [(key >> _APP_BITS_SHIFT, key & _BLOCK_MASK,
                              t0, now)
                             for key, t0 in sorted(self.block_open.items())]
        self._meta = self._snapshot_meta()

    def _ensure(self) -> None:
        if self._finished and not self._consolidated:
            self._consolidate()

    # Lazy read surface: every post-run consumer (exporters, diagnosis,
    # fleet aggregation, tests) reaches the data through these properties,
    # which trigger the one-time consolidation. Before finish() they
    # return the live raw state unchanged.
    @property
    def spans(self) -> List[Tuple]:
        self._ensure()
        return self._spans

    @property
    def instants(self) -> List[Tuple]:
        self._ensure()
        return self._instants

    @property
    def registry(self) -> MetricsRegistry:
        self._ensure()
        return self._registry

    @property
    def meta(self) -> Dict[str, object]:
        self._ensure()
        return self._meta if self._meta is not None else {}

    @property
    def open_blocks(self) -> List[Tuple[int, int, float, float]]:
        self._ensure()
        return self._open_blocks if self._open_blocks is not None else []

    def _snapshot_meta(self) -> Dict[str, object]:
        """JSON-safe run metadata for ``analysis.RunView``: per-app
        participant sets, tenants and lifecycle times, plus structural link
        names index-aligned with the ``link/{i}/*`` probe series."""
        sim = self.sim
        apps: Dict[int, dict] = {}
        for app, job in sim.jobs.items():
            apps[app] = {
                "participants": sorted(job.participants),
                "tenant": int(sim.tenant_of.get(app, app)),
                "collective": job.collective,
                "data_bytes": int(job.data_bytes),
                "submit_ns": float(sim.job_submit_ns.get(app, 0.0)),
                "finish_ns": sim.app_done_ns.get(app),
            }
        try:
            link_names = list(sim.net.link_names())
        except Exception:  # plug-in topologies predating link_names()
            link_names = [f"link/{i}" for i in range(len(self._links))]
        return {"apps": apps, "link_names": link_names,
                "topology": str(self.cfg.topology),
                "num_hosts": int(self.cfg.num_hosts)}

    def truncation_dict(self) -> Dict[str, object]:
        """Cap-hit accounting for the diagnosis layer. A truncated run
        under-records instant-driven causes, so any non-zero entry here must
        surface prominently in diagnosis output (never silently
        under-attribute — see ARCHITECTURE.md §Diagnosis)."""
        return {
            "spans_dropped": int(self.spans_dropped),
            "samples_dropped": int(self._registry.samples_dropped()),
            "pkt_instants_capped": bool(
                self._spans_on and self._max_pkt > 0
                and not self.want_pkt_instants),
        }

    # ---------------------------------------------------------------- probes
    def _sample(self, now: float) -> None:
        reg = self._registry
        # per-link queue backlog (delta-encoded: idle links record one point)
        hi = 0.0
        total = 0.0
        for link, ts in zip(self._links, self._link_ts):
            b = link.busy_until - now
            b = b * link.bytes_per_ns if b > 0.0 else 0.0
            ts.record(now, b)
            total += b
            if b > hi:
                hi = b
        reg.record("net/backlog_max_bytes", now, hi)
        reg.record("net/backlog_total_bytes", now, total)
        # per-switch descriptor occupancy + the cross-switch max the
        # OccupancyModel bound is compared against (the exact high-water
        # gauge is event-driven at on_desc_alloc; these sampled series show
        # the shape between allocs)
        if self._tables:
            occ_hi = 0
            for sts, table in zip(self._sw_ts, self._tables):
                n = len(table)
                sts.record(now, n)
                if n > occ_hi:
                    occ_hi = n
            reg.record("switch/max_descriptors", now, occ_hi)
        # per-app outstanding completions (blocks still in flight)
        for app, left in self.sim.app_remaining.items():
            reg.record(f"app/{app}/remaining", now, left)
        # transport counters -> cumulative series + per-us rates
        tp = self._tp
        if tp is not None:
            last = self._tp_last
            dt_us = self.probe_ns / 1e3
            for attr in ("ecn_marks", "cnps", "pfc_pauses", "rate_cuts",
                         "gbn_retx", "gbn_ooo"):
                v = getattr(tp, attr, None)
                if v is None:
                    continue
                reg.record(f"tp/{attr}", now, v)
                prev = last.get(attr, 0.0)
                reg.record(f"tp/{attr}_per_us", now, (v - prev) / dt_us)
                last[attr] = v
            cc = getattr(tp, "_cc", None)
            if cc is not None:  # DCQCN: per-host pacing rate in Gb/s
                for h, st in enumerate(cc):
                    reg.record(f"host/{h}/rate_gbps", now, st.rate * 8.0)

    # ------------------------------------------------------- span primitives
    def _push_span(self, entry: Tuple) -> None:
        if len(self._spans) < self._max_spans:
            self._spans.append(entry)
        else:
            self.spans_dropped += 1

    def _push_instant(self, entry: Tuple) -> None:
        if len(self._instants) < self._max_spans:
            self._instants.append(entry)
        else:
            self.spans_dropped += 1

    # ------------------------------------------------------- lifecycle hooks
    # The five hooks below run once per protocol event in the hottest loops,
    # so they inline the span/series bookkeeping instead of going through
    # _push_span / TimeSeries.record — every saved call is measurable
    # against the perf budget.

    def on_host_send(self, host: int, pkt) -> None:
        """First REDUCE contribution of a block opens its lifecycle span.
        The call site inlines the common-case rejection (block already open,
        checked against the pre-bound ``_tel_open`` dict) and only calls
        here once per distinct block; when the last block has opened the hub
        retracts ``_tel_open`` and the send site goes fully cold."""
        key = pkt.id >> GEN_BITS  # generation-free (app, block) packing
        self.block_open[key] = self._engine.now
        self.blocks_started += 1
        if self.blocks_started == self._total_blocks:
            self.want_sends = False
            self._strategy._tel_open = None

    def on_leader_done(self, host: int, app: int, block: int) -> None:
        """The leader holds the fully-reduced block; broadcast begins."""
        if self._spans_on:
            now = self._engine.now
            self._leader_done_t[(app << _APP_BITS_SHIFT) | block] = now
            ins = self._instants
            if len(ins) < self._max_spans:
                ins.append(("leader_done", app, block, host, now))
            else:
                self.spans_dropped += 1

    def on_block_complete(self, host: int, app: int, block: int) -> None:
        """The LAST participant of a block holds the final result: close the
        block span (and the leader-done -> done broadcast sub-span). The
        call site decrements ``block_left[app][block]`` inline and calls
        here only when the countdown hits zero — once per block, not once
        per participant completion."""
        key = (app << _APP_BITS_SHIFT) | block
        now = self._engine.now
        t0 = self.block_open.pop(key, None)
        t_ld = self._leader_done_t.pop(key, None)
        spans = self._spans
        if t_ld is not None and t_ld < now:
            if len(spans) < self._max_spans:
                spans.append(("bcast", app, block, t_ld, now))
            else:
                self.spans_dropped += 1
        if t0 is None:
            t0 = t_ld  # host-based paths with no recorded first send
        if t0 is not None:
            if len(spans) < self._max_spans:
                spans.append(("block", app, block, t0, now, host))
            else:
                self.spans_dropped += 1
            self._lat_vals.append(now - t0)
        self.blocks_completed += 1

    # ------------------------------------------------------ descriptor sites
    # There are no on_desc_alloc/on_desc_flush methods: both sites are
    # inlined into switch.py against hub-owned state installed at
    # finalize() — the alloc site maxes occupancy into ``_sw_hi`` (exact
    # event-driven high-water at any probe cadence: occupancy only rises
    # at an alloc, so deallocs need no site at all) and counts into
    # ``strategy._tel_desc_n``; the flush site appends the raw
    # ``(sw, desc, reason, nchildren, now)`` record — retaining the
    # descriptor object itself, which is not pooled — or a slim
    # ``(reason, duration)`` pair past the span cap, into ``_desc_log``.
    # finish() syncs the counters; _consolidate() decodes spans and
    # replays the window histogram.

    # ------------------------------------------------------ pkt-instant sites
    # There are no on_collision/on_straggler methods either: collisions and
    # especially stragglers are per-*packet* events — a congested cell emits
    # tens of thousands — so both sites are inlined into switch.py as plain
    # appends into ``_pkt_instants`` (installed as ``strategy._tel_pkt`` at
    # start()), logging the RAW packed packet id; consolidation decodes
    # app/block once per surviving entry when it merges the log. Once the
    # log reaches ``_tel_pkt_cap`` entries the site retracts itself and
    # drops ``want_pkt_instants``. The simulator already counts both events
    # at the same call sites (SimResult carries the authoritative totals,
    # finish() copies them into the hub), so nothing is lost when the site
    # goes cold.

    def on_drop(self, cause: str, where: int) -> None:
        """A packet died: ``cause`` is "wire" (iid link loss) or
        "switch_fail" (arrival at a dead switch)."""
        self._registry.inc("drops/" + cause)
        if self._spans_on:
            self._push_instant(("drop", cause, where, self._engine.now))

    def on_fault(self, kind: str, target, active: bool) -> None:
        """A fault-injection edge (repro.core.faults): ``active`` True when
        the fault lands, False at its heal. The instant pairs become
        ``RunView.fault_intervals()`` and the ``fault_recovery`` attribution
        cause."""
        self._registry.inc("faults/" + kind)
        if self._spans_on:
            self._push_instant(("fault", kind, target, active,
                                self._engine.now))

    def on_retx(self, what: str, host: int, app: int, block: int) -> None:
        """Whole-block recovery traffic: ``what`` is "request" (a host asked
        its leader) or "fail" (the leader re-issued the reduction)."""
        self._registry.inc("retx/" + what)
        if self._spans_on:
            self._push_instant(("retx", what, app, host, block,
                                self._engine.now))

    def on_cnp(self, src: int, dst: int) -> None:
        """DCQCN congestion-notification packet from receiver to sender."""
        self._registry.inc("tp/cnp_sent")
        if self._spans_on:
            self._push_instant(("cnp", dst, src, self._engine.now))

    def on_pfc(self, host: int, paused: bool) -> None:
        self._registry.inc("tp/pfc_pause" if paused else "tp/pfc_resume")
        if self._spans_on:
            self._push_instant(("pfc", host, paused, self._engine.now))

    def on_gbn(self, what: str, host: int, count: int = 1) -> None:
        """Go-back-N recovery: ``what`` is "retx" (window resent on timer)
        or "ooo" (out-of-order arrival discarded at the endpoint)."""
        self._registry.inc("tp/gbn_" + what, count)
        if self._spans_on:
            self._push_instant(("gbn", what, host, count, self._engine.now))

    # ---------------------------------------------------------------- digest
    def desc_high_water(self) -> int:
        """Exact max descriptor-table occupancy seen across all switches
        (event-driven — cross-validated against
        ``SimResult.max_descriptors_per_switch``)."""
        return max(self._sw_hi, default=0)

    def summary_dict(self) -> Dict[str, float]:
        """Flat numeric digest for ``SimResult.telemetry_summary``."""
        # deliberately reads the raw attributes, not the consolidating
        # properties: the summary is built inside Simulator.run and must not
        # trigger the lazy decode; finish() froze the exact totals already.
        # The post-finish digest is cached so later calls return the same
        # values even after consolidation adds the closing probe sample to
        # the registry — the summary describes the run, not the reader.
        if self._summary is not None:
            return self._summary
        reg = self._registry
        net = reg.series.get("net/backlog_max_bytes")
        d = {
            "probes": float(self.probes),
            "spans": float(self.spans_total if self._finished
                           else len(self._spans)),
            "instants": float(self.instants_total if self._finished
                              else len(self._instants)),
            "spans_dropped": float(self.spans_dropped),
            "series": float(len(reg.series)),
            "samples": float(reg.total_samples()),
            "samples_dropped": float(reg.samples_dropped()),
            "desc_high_water": float(self.desc_high_water()),
            "max_link_backlog_bytes":
                float(net.hi) if net is not None and len(net) else 0.0,
            "occupancy_model_bytes": self.occupancy_model_bytes,
            "occupancy_model_descriptors": self.occupancy_model_descriptors,
            "desc/flush_timeout": float(self.flush_timeout),
            "desc/flush_complete": float(self.flush_complete),
            "desc/alloc": float(self.desc_allocs),
            "switch/collisions": float(self.collisions),
            "switch/stragglers": float(self.stragglers),
            "blocks/started": float(self.blocks_started),
            "blocks/completed": float(self.blocks_completed),
        }
        if self._finished:
            self._summary = d
        return d
