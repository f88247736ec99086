"""Critical-path slowdown attribution: *why* was this run slow?

The decomposition half of the diagnosis layer (ARCHITECTURE.md §Diagnosis;
the raw-telemetry views live in ``analysis.py``). Every completed block span
is partitioned along its own time axis into a **closed taxonomy of causes**:

========================  ==================================================
``bcast_tail``            leader-done -> last-participant completion
                          broadcast (the block is reduced, hosts are still
                          learning about it)
``fault_recovery``        injected-fault windows (repro.core.faults): block
                          time spent while a switch crash, link failure or
                          host straggler fault was active — the most
                          specific evidence, claimed before the congestion
                          symptoms the fault also produces
``pfc_pause``             fabric-wide PFC pause windows (transport=dcqcn
                          with PFC enabled)
``retx_recovery``         loss-recovery windows: block-level retx requests
                          and go-back-N timer retransmits, each counted as
                          the timeout window ``[t - timeout, t]`` that
                          preceded the recovery instant. Block-level retx
                          windows only count when the run recorded actual
                          loss (``RunView.loss_evidence``) — a retx request
                          under zero loss is a congestion *symptom* and its
                          wait time belongs to the causes below
``collision_bypass``      §3.2.1 descriptor-collision detours: the
                          contribution skipped in-network aggregation and
                          was host-aggregated at the leader instead.
                          Evidence is the *serialized* detour windows (the
                          leader processes bypassed contributions one at a
                          time) plus congestion on the leader's own
                          down-link — bypass traffic is unicast to the
                          leader, so a backlog there while collisions are
                          recorded is the bypass convoy, not generic
                          fabric queueing
``dcqcn_pacing``          windows during which a participant was DCQCN-paced
                          below line rate
``queueing``              windows during which the most-backlogged fabric
                          link held more than one MTU of queued bytes
``timeout_flush``         §3.1.1 best-effort timeout stalls: the tail of
                          each descriptor window that flushed by timeout
                          (the switch sat waiting for children that never
                          came). Ranked *below* pacing and queueing: a
                          timeout window spent congested or paced is those
                          causes' fault — what is left is the switch idly
                          waiting for a child that was merely late (noise)
                          or never sent
``wire``                  the uncontended floor: per-hop serialization +
                          propagation across the fabric plus the host-side
                          leader aggregate, capped at the topology estimate
``other``                 the explicit residual — whatever the recorded
                          signals cannot explain
========================  ==================================================

**Conservation contract.** Causes are measured as *disjoint interval
subsets* of the block's own span ``[t0, t1)``: each extractor intersects
its evidence intervals with the still-unattributed remainder and subtracts
what it takes, in the priority order above (most-specific evidence first),
and ``other`` is defined as the leftover measure. The components therefore
sum to the measured span *by construction*; the only slack is float
rounding across the interval arithmetic, so the documented tolerance is
``CONSERVATION_REL_TOL`` (relative, default 1e-6) — not a fudge factor for
modelling error, which lands in ``other`` instead and stays visible.
``tests/core/test_diagnosis.py`` property-tests the contract on congested
fat_tree and three_tier cells and pins that each injected bottleneck (hot
link, table_size collisions, loss+gbn, DCQCN pacing) surfaces as the top
cause.

Adding a cause (the recipe, also in ARCHITECTURE.md §Diagnosis): derive an
``Intervals`` evidence set from spans/instants/series in ``RunView``, insert
one ``_take(...)`` call at the right specificity rank in
:func:`attribute_block`, add the name to ``CAUSES`` — conservation then
holds automatically, and the property test will fail if the new extractor
overlaps the span boundary.

Job-level attribution composes per-block results along the job's critical
path (``analysis.critical_path``): each path segment contributes its
block's causes scaled by the fraction of that block's span the segment
covers, and idle gaps (time no block span covers) land in ``other``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .analysis import (BlockRecord, Hotspot, Intervals, RunView,
                       critical_path, hotspots, job_interval)

__all__ = ["CAUSES", "CONSERVATION_REL_TOL", "BlockAttribution",
           "AppAttribution", "Diagnosis", "attribute_block",
           "attribute_app", "diagnose"]

# the closed taxonomy, in attribution priority order (most specific first);
# report output preserves this order for stable diffs
CAUSES = ("bcast_tail", "fault_recovery", "pfc_pause", "retx_recovery",
          "collision_bypass", "dcqcn_pacing", "queueing", "timeout_flush",
          "wire", "other")

# conservation tolerance: float rounding across interval subtraction only —
# sum(causes) is structurally <= span, and `other` absorbs the remainder,
# so any drift beyond accumulated ulps is a bug, not noise
CONSERVATION_REL_TOL = 1e-6
_ABS_TOL_NS = 1e-3


def _tol(span_ns: float) -> float:
    return max(_ABS_TOL_NS, abs(span_ns) * CONSERVATION_REL_TOL)


@dataclass
class BlockAttribution:
    """One block's span decomposed into the closed cause taxonomy."""

    app: int
    block: int
    t0: float
    t1: float
    causes: Dict[str, float]
    complete: bool = True

    @property
    def span_ns(self) -> float:
        return self.t1 - self.t0

    def conservation_error_ns(self) -> float:
        return abs(sum(self.causes.values()) - self.span_ns)

    def check(self) -> None:
        """Raise if the conservation contract is violated."""
        err = self.conservation_error_ns()
        if err > _tol(self.span_ns):
            raise AssertionError(
                f"conservation violated for app {self.app} block "
                f"{self.block}: causes sum to "
                f"{sum(self.causes.values()):.6f} ns vs span "
                f"{self.span_ns:.6f} ns (err {err:.6f} ns)")

    def top_cause(self) -> str:
        return max(CAUSES, key=lambda c: self.causes.get(c, 0.0))

    def to_dict(self) -> dict:
        return {"app": self.app, "block": self.block, "t0": self.t0,
                "t1": self.t1, "span_ns": self.span_ns,
                "complete": self.complete, "causes": dict(self.causes)}


@dataclass
class AppAttribution:
    """One job's makespan decomposed along its critical path."""

    app: int
    tenant: int
    t0: float
    t1: float
    causes: Dict[str, float]
    n_blocks: int
    idle_ns: float   # critical-path gaps (counted inside causes["other"])

    @property
    def makespan_ns(self) -> float:
        return self.t1 - self.t0

    def top_cause(self) -> str:
        return max(CAUSES, key=lambda c: self.causes.get(c, 0.0))

    def to_dict(self) -> dict:
        return {"app": self.app, "tenant": self.tenant,
                "makespan_ns": self.makespan_ns, "n_blocks": self.n_blocks,
                "idle_ns": self.idle_ns, "causes": dict(self.causes)}


# ------------------------------------------------------------ per-block core
def _take(remaining: Intervals, evidence: Intervals,
          causes: Dict[str, float], name: str) -> Intervals:
    """Attribute ``remaining ∩ evidence`` to ``name``; return the new
    remainder. This is the conservation mechanism: every cause takes a
    disjoint subset of the block's own time axis."""
    got = remaining.intersect(evidence)
    m = got.measure()
    if m > 0.0:
        causes[name] += m
        return remaining.subtract(got)
    return remaining


def attribute_block(view: RunView, blk: BlockRecord) -> BlockAttribution:
    """Decompose one block span into the closed cause taxonomy (see module
    docstring for the priority order and the conservation argument)."""
    t0, t1 = blk.t0, blk.t1
    causes = {c: 0.0 for c in CAUSES}
    out = BlockAttribution(app=blk.app, block=blk.block, t0=t0, t1=t1,
                           causes=causes, complete=blk.complete)
    total = t1 - t0
    if total <= 0.0:
        return out
    remaining = Intervals([(t0, t1)])

    # 1. broadcast tail: everything after leader_done is the done-broadcast
    if blk.bcast_t0 is not None and t0 <= blk.bcast_t0 < t1:
        causes["bcast_tail"] = t1 - blk.bcast_t0
        remaining = Intervals([(t0, blk.bcast_t0)])

    # 2. fault-active windows (repro.core.faults): a crashed switch, dead
    #    link or paused host is the most specific possible evidence — any
    #    block time spent inside one is fault recovery, whatever congestion
    #    symptoms it also produced
    fault_iv = view.fault_intervals()
    if not fault_iv.is_empty():
        remaining = _take(remaining, fault_iv, causes, "fault_recovery")

    # 3. PFC pause windows (fabric-wide union: a paused sender stalls the
    #    reduction tree feeding it, so any overlap is attributable)
    remaining = _take(remaining, view.pfc_intervals(), causes, "pfc_pause")

    # 4. loss-recovery windows: each recovery instant at time t implies the
    #    preceding timeout window [t - timeout, t] was spent waiting
    parts = set(view.participants(blk.app))
    ivs: List[Tuple[float, float]] = []
    if view.loss_evidence:
        for _what, t in view.retx_instants(blk.app, blk.block):
            ivs.append((t - view.retx_timeout_ns, t))
    for _host, t in view.gbn_retx_instants(parts or None):
        ivs.append((t - view.gbn_timeout_ns, t))
    if ivs:
        remaining = _take(remaining, Intervals(ivs), causes, "retx_recovery")

    # 5. collision detours. The leader host-aggregates bypassed
    #    contributions serially, so the detour windows chain: each starts
    #    when its collision fired or when the previous detour finished,
    #    whichever is later. While collisions are on record for this block,
    #    backlog on the leader's own down-link is the bypass convoy itself
    #    (unicast to the leader), so those windows count as evidence too.
    col_t = view.collision_instants(blk.app, blk.block)
    if col_t:
        det = view.collision_detour_ns
        ivs = []
        cur = -math.inf
        for t in sorted(col_t):
            s = t if t > cur else cur
            ivs.append((s, s + det))
            cur = s + det
        if blk.leader is not None:
            down = view.num_hosts + blk.leader  # leaf->leader link index
            ivs.extend(view.link_congested_intervals(down).spans)
        remaining = _take(remaining, Intervals(ivs), causes,
                          "collision_bypass")

    # 6. DCQCN pacing: windows with any participant below line rate
    if parts:
        pace = view.pacing_intervals(sorted(parts))
        if not pace.is_empty():
            remaining = _take(remaining, pace, causes, "dcqcn_pacing")

    # 7. queueing: remaining time while a link that can carry this app's
    #    traffic held > 1 MTU of backlog (bystander host links excluded)
    remaining = _take(remaining, view.app_congested_intervals(sorted(parts)),
                      causes, "queueing")

    # 8. timeout-flush stalls: the waited-out tail of each timeout window
    #    (only what pacing/queueing above did not already claim — an idle
    #    switch waiting out its window on an uncongested fabric)
    ivs = [(max(w.t0, w.t1 - view.timeout_ns), w.t1)
           for w in view.desc_windows(blk.app, blk.block)
           if w.reason == "timeout"]
    if ivs:
        remaining = _take(remaining, Intervals(ivs), causes, "timeout_flush")

    # 9. wire floor, capped at the topology estimate; the rest is residual
    rest = remaining.measure()
    wire = min(rest, view.wire_estimate_ns)
    causes["wire"] = wire
    # exact-by-construction closure: `other` is defined as the leftover
    causes["other"] = max(0.0, total - sum(
        v for c, v in causes.items() if c != "other"))
    return out


# ------------------------------------------------------------- per-job level
def attribute_app(view: RunView, app: int,
                  block_attrs: Optional[Dict[Tuple[int, int],
                                             BlockAttribution]] = None
                  ) -> Optional[AppAttribution]:
    """Compose per-block attributions along ``app``'s critical path. Each
    path segment contributes its block's causes scaled by the fraction of
    the block span the segment covers; idle gaps land in ``other``."""
    path = critical_path(view, app)
    if not path:
        return None
    if block_attrs is None:
        block_attrs = {}
    causes = {c: 0.0 for c in CAUSES}
    idle = 0.0
    n_blocks = 0
    for seg in path:
        if seg.block is None:
            idle += seg.span_ns
            causes["other"] += seg.span_ns
            continue
        n_blocks += 1
        key = (seg.block.app, seg.block.block)
        ba = block_attrs.get(key)
        if ba is None:
            ba = block_attrs[key] = attribute_block(view, seg.block)
        if ba.span_ns > 0.0:
            scale = seg.span_ns / ba.span_ns
            for c, v in ba.causes.items():
                causes[c] += v * scale
    iv = job_interval(view, app)
    return AppAttribution(app=app, tenant=view.tenant_of(app), t0=iv[0],
                          t1=iv[1], causes=causes, n_blocks=n_blocks,
                          idle_ns=idle)


# ---------------------------------------------------------------- diagnosis
@dataclass
class Diagnosis:
    """The full diagnosis of one run: per-block and per-job attributions,
    ranked totals, congestion hotspots (global and per-tenant) and the
    truncation state that qualifies all of it."""

    per_block: List[BlockAttribution]
    per_app: Dict[int, AppAttribution]
    per_tenant: Dict[int, Dict[str, float]]
    totals: Dict[str, float]
    hotspots: List[Hotspot]
    tenant_hotspots: Dict[int, List[Hotspot]]
    truncation: Dict[str, object]
    notes: List[str] = field(default_factory=list)

    @property
    def truncated(self) -> bool:
        return bool(self.truncation.get("spans_dropped", 0)
                    or self.truncation.get("samples_dropped", 0)
                    or self.truncation.get("pkt_instants_capped", False))

    def ranked(self) -> List[Tuple[str, float, float]]:
        """Causes as (name, ns, fraction-of-total), largest first."""
        total = sum(self.totals.values())
        out = [(c, self.totals.get(c, 0.0),
                self.totals.get(c, 0.0) / total if total > 0.0 else 0.0)
               for c in CAUSES]
        out.sort(key=lambda r: r[1], reverse=True)
        return out

    def top_cause(self) -> str:
        r = self.ranked()
        return r[0][0] if r else "other"

    def to_json(self) -> dict:
        return {
            "top_cause": self.top_cause(),
            "totals_ns": {c: self.totals.get(c, 0.0) for c in CAUSES},
            "ranked": [{"cause": c, "ns": ns, "frac": frac}
                       for c, ns, frac in self.ranked()],
            "per_app": {str(a): aa.to_dict()
                        for a, aa in sorted(self.per_app.items())},
            "per_tenant": {str(t): dict(c)
                           for t, c in sorted(self.per_tenant.items())},
            "per_block": [b.to_dict() for b in self.per_block],
            "hotspots": [h.to_dict() for h in self.hotspots],
            "tenant_hotspots": {str(t): [h.to_dict() for h in hs]
                                for t, hs in
                                sorted(self.tenant_hotspots.items())},
            "truncated": self.truncated,
            "truncation": dict(self.truncation),
            "notes": list(self.notes),
        }

    def to_text(self) -> str:
        """The human 'why was this slow' report."""
        lines: List[str] = []
        w = lines.append
        w("== diagnosis: why was this run slow? " + "=" * 34)
        if self.truncated:
            w("!! TELEMETRY TRUNCATED "
              f"(spans_dropped={self.truncation.get('spans_dropped', 0)}, "
              f"samples_dropped={self.truncation.get('samples_dropped', 0)}, "
              "pkt_instants_capped="
              f"{self.truncation.get('pkt_instants_capped', False)}) --")
            w("!! instant-driven causes below are a LOWER BOUND; raise the "
              "telemetry_max_* caps for a complete attribution")
        for note in self.notes:
            w(f"note: {note}")
        total = sum(self.totals.values())
        w(f"critical-path attribution over {len(self.per_app)} job(s), "
          f"{len(self.per_block)} block span(s), "
          f"{total / 1e3:.1f} us attributed:")
        for cause, ns, frac in self.ranked():
            if ns <= 0.0:
                continue
            bar = "#" * max(1, int(round(frac * 40)))
            w(f"  {cause:<18}{ns / 1e3:>12.1f} us  {frac * 100:>5.1f}%  "
              f"{bar}")
        if self.hotspots:
            w("top congestion hotspots (mean queue delay over the run):")
            for i, h in enumerate(self.hotspots[:10], 1):
                w(f"  {i:>2}. {h.name:<20}{h.mean_queue_ns / 1e3:>9.2f} us "
                  f"mean | peak {h.peak_backlog_bytes / 1024.0:.1f} KiB | "
                  f"busy {h.busy_frac * 100:.0f}%")
        for app, aa in sorted(self.per_app.items()):
            w(f"app {app} (tenant {aa.tenant}): makespan "
              f"{aa.makespan_ns / 1e3:.1f} us over {aa.n_blocks} "
              f"critical-path block(s), top cause: {aa.top_cause()}")
        if len(self.per_tenant) > 1:
            w("per-tenant attribution:")
            for t, causes in sorted(self.per_tenant.items()):
                tot = sum(causes.values())
                top = max(CAUSES, key=lambda c: causes.get(c, 0.0))
                hs = self.tenant_hotspots.get(t) or []
                hot = f", hottest link: {hs[0].name}" if hs else ""
                w(f"  tenant {t}: {tot / 1e3:.1f} us attributed, top cause "
                  f"{top}{hot}")
        return "\n".join(lines)


def diagnose(view: RunView, top_links: int = 10) -> Diagnosis:
    """Run the full diagnosis over one run's telemetry."""
    notes: List[str] = []
    blocks = view.blocks()
    if not blocks:
        notes.append("no block spans recorded "
                     "(telemetry_spans off or zero blocks) -- "
                     "no per-block attribution possible")
    if not view.probes_on:
        notes.append("probes disabled: queueing / dcqcn_pacing attribution "
                     "and hotspot ranking are unavailable")
    open_blocks = [b for b in blocks if not b.complete]
    if open_blocks:
        notes.append(f"{len(open_blocks)} block(s) still open at end of run "
                     "-- their spans are truncated at the run end")

    block_attrs: Dict[Tuple[int, int], BlockAttribution] = {}
    per_app: Dict[int, AppAttribution] = {}
    for app in view.apps():
        aa = attribute_app(view, app, block_attrs)
        if aa is not None:
            per_app[app] = aa
    # blocks never on any critical path still get attributed (the per-block
    # section is the complete record; the totals are path-weighted)
    for blk in blocks:
        key = (blk.app, blk.block)
        if key not in block_attrs:
            block_attrs[key] = attribute_block(view, blk)

    totals = {c: 0.0 for c in CAUSES}
    per_tenant: Dict[int, Dict[str, float]] = {}
    tenant_windows: Dict[int, Intervals] = {}
    for app, aa in per_app.items():
        for c, v in aa.causes.items():
            totals[c] += v
        tc = per_tenant.setdefault(aa.tenant, {c: 0.0 for c in CAUSES})
        for c, v in aa.causes.items():
            tc[c] += v
        iv = job_interval(view, app)
        if iv is not None:
            win = tenant_windows.get(aa.tenant, Intervals())
            tenant_windows[aa.tenant] = win.union(Intervals([iv]))

    hs = hotspots(view, top=top_links)
    tenant_hs = {t: hotspots(view, window=win, top=top_links)
                 for t, win in tenant_windows.items()} \
        if len(tenant_windows) > 1 else {}

    diag = Diagnosis(per_block=sorted(block_attrs.values(),
                                      key=lambda b: (b.app, b.block)),
                     per_app=per_app, per_tenant=per_tenant, totals=totals,
                     hotspots=hs, tenant_hotspots=tenant_hs,
                     truncation=view.truncation, notes=notes)
    for ba in diag.per_block:
        ba.check()
    return diag
