"""Post-run telemetry analysis: structured views, critical paths, hotspots.

This is the *reading* half of the diagnosis layer (ARCHITECTURE.md
§Diagnosis; the cause decomposition lives in ``attribution.py``). It never
touches the simulator — everything here consumes either a finished
:class:`~repro.core.telemetry.hub.Telemetry` hub (:func:`view_of`) or the
full-fidelity JSON dump the exporters write (:func:`load_dump` /
``export.write_dump``), so a diagnosis can run long after the process that
produced the telemetry is gone.

Three layers:

* :class:`Intervals` — a tiny sorted-disjoint interval-set algebra
  (union / subtract / intersect / measure over half-open ``[a, b)``
  ranges). The attribution's conservation contract rests on it: causes are
  *disjoint subsets of the block's own time axis*, so their measures can
  never sum past the measured span.
* :class:`RunView` — one run's telemetry as plain data: block lifecycle
  records (:class:`BlockRecord`), per-block descriptor windows, instant
  streams, probe series, config, metadata and truncation state, with the
  derived quantities attribution needs (wire estimate, pacing/PFC/congested
  intervals) computed lazily.
* :func:`critical_path` / :func:`hotspots` — per-job backward critical-path
  extraction over block spans (each instant of the job makespan is assigned
  to the block that was the *latest-finishing cover* for it, gaps become
  explicit idle segments) and per-link queueing-delay ranking over any
  window (per-tenant windows when run through the fleet driver).

Everything is plain Python with no simulator or jax imports.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Intervals", "BlockRecord", "DescWindow", "RunView", "Hotspot",
           "PathSegment", "view_of", "load_dump", "critical_path",
           "hotspots", "step_intervals_above", "step_integral"]


# ---------------------------------------------------------------- intervals
class Intervals:
    """Sorted, disjoint, half-open ``[a, b)`` interval set."""

    __slots__ = ("spans",)

    def __init__(self, spans: Optional[Iterable[Tuple[float, float]]] = None):
        merged: List[Tuple[float, float]] = []
        if spans:
            for a, b in sorted((float(a), float(b)) for a, b in spans):
                if b <= a:
                    continue
                if merged and a <= merged[-1][1]:
                    if b > merged[-1][1]:
                        merged[-1] = (merged[-1][0], b)
                else:
                    merged.append((a, b))
        self.spans = merged

    def measure(self) -> float:
        return sum(b - a for a, b in self.spans)

    def is_empty(self) -> bool:
        return not self.spans

    def union(self, other: "Intervals") -> "Intervals":
        return Intervals(self.spans + other.spans)

    def intersect(self, other: "Intervals") -> "Intervals":
        out, i, j = [], 0, 0
        a_sp, b_sp = self.spans, other.spans
        while i < len(a_sp) and j < len(b_sp):
            lo = max(a_sp[i][0], b_sp[j][0])
            hi = min(a_sp[i][1], b_sp[j][1])
            if hi > lo:
                out.append((lo, hi))
            if a_sp[i][1] <= b_sp[j][1]:
                i += 1
            else:
                j += 1
        r = Intervals.__new__(Intervals)
        r.spans = out
        return r

    def subtract(self, other: "Intervals") -> "Intervals":
        out = []
        j = 0
        b_sp = other.spans
        for a, b in self.spans:
            cur = a
            while j < len(b_sp) and b_sp[j][1] <= cur:
                j += 1
            k = j
            while k < len(b_sp) and b_sp[k][0] < b:
                if b_sp[k][0] > cur:
                    out.append((cur, b_sp[k][0]))
                cur = max(cur, b_sp[k][1])
                if cur >= b:
                    break
                k += 1
            if cur < b:
                out.append((cur, b))
        r = Intervals.__new__(Intervals)
        r.spans = out
        return r

    def clip(self, a: float, b: float) -> "Intervals":
        return self.intersect(Intervals([(a, b)]))

    def __repr__(self) -> str:  # debugging aid
        return f"Intervals({self.spans!r})"


# ------------------------------------------------------- step-function math
def step_intervals_above(t: Sequence[float], v: Sequence[float],
                         thresh: float, t_end: float) -> Intervals:
    """Intervals where the delta-encoded step series ``(t, v)`` exceeds
    ``thresh``. The series is right-continuous (each sample holds until the
    next) and the last value extends to ``t_end``."""
    spans = []
    open_at: Optional[float] = None
    for i, (ti, vi) in enumerate(zip(t, v)):
        if vi > thresh:
            if open_at is None:
                open_at = ti
        elif open_at is not None:
            spans.append((open_at, ti))
            open_at = None
    if open_at is not None and t_end > open_at:
        spans.append((open_at, t_end))
    return Intervals(spans)


def step_integral(t: Sequence[float], v: Sequence[float],
                  a: float, b: float) -> float:
    """``∫ v dt`` over ``[a, b]`` for a right-continuous step series whose
    last value extends past its final sample."""
    if b <= a or not t:
        return 0.0
    total = 0.0
    for i, ti in enumerate(t):
        seg_lo = max(ti, a)
        seg_hi = min(t[i + 1] if i + 1 < len(t) else b, b)
        if seg_hi > seg_lo:
            total += v[i] * (seg_hi - seg_lo)
    # before the first sample the series is implicitly 0, so nothing to add
    return total


# ------------------------------------------------------------------ records
@dataclass
class BlockRecord:
    """One block's lifecycle, reassembled from the hub's raw span tuples."""

    app: int
    block: int
    t0: float
    t1: float
    last_host: int = -1
    bcast_t0: Optional[float] = None   # leader_done -> done broadcast start
    leader: Optional[int] = None       # leader host (from leader_done)
    complete: bool = True              # False: still open at end of run

    @property
    def span_ns(self) -> float:
        return self.t1 - self.t0


@dataclass(frozen=True)
class DescWindow:
    """One descriptor aggregation window (alloc -> flush) on one switch."""

    sw: int
    reason: str      # "timeout" | "complete"
    merges: int
    t0: float
    t1: float


@dataclass
class Hotspot:
    """One link's queueing contribution over an analysis window."""

    link: int
    name: str
    mean_queue_ns: float     # time-averaged queue delay over the window
    peak_backlog_bytes: float
    busy_frac: float         # fraction of the window with backlog > 0

    def to_dict(self) -> dict:
        return {"link": self.link, "name": self.name,
                "mean_queue_ns": self.mean_queue_ns,
                "peak_backlog_bytes": self.peak_backlog_bytes,
                "busy_frac": self.busy_frac}


@dataclass(frozen=True)
class PathSegment:
    """One backward-walk segment of a job's makespan: either the portion of
    ``block``'s span that was the latest-finishing cover, or (``block is
    None``) an idle gap no recorded block span covers."""

    t0: float
    t1: float
    block: Optional[BlockRecord]

    @property
    def span_ns(self) -> float:
        return self.t1 - self.t0


# ----------------------------------------------------------------- run view
_FT_HOPS = 4          # host -> leaf -> spine -> leaf -> host
_TT_HOPS = 6          # host -> leaf -> agg -> core -> agg -> leaf -> host


class RunView:
    """One run's telemetry as plain, simulator-free data.

    Build with :func:`view_of` (live hub) or :func:`load_dump` (exported
    JSON); both produce identical views — the round trip is pinned by
    ``tests/core/test_diagnosis.py``.
    """

    def __init__(self, cfg: dict, meta: dict, spans: List[tuple],
                 instants: List[tuple], open_blocks: List[tuple],
                 series: Dict[str, Tuple[List[float], List[float]]],
                 counters: Dict[str, float], summary: Dict[str, float],
                 truncation: Dict[str, object]):
        self.cfg = cfg
        self.meta = meta or {}
        self.spans = spans
        self.instants = instants
        self.open_blocks = open_blocks
        self.series = series
        self.counters = counters
        self.summary = summary
        self.truncation = truncation or {}
        self._blocks: Optional[List[BlockRecord]] = None
        self._desc: Optional[Dict[Tuple[int, int], List[DescWindow]]] = None
        self._pfc: Optional[Intervals] = None
        self._fault_iv: Optional[Intervals] = None
        self._congested: Optional[Intervals] = None
        self._app_congested: Dict[Tuple[int, ...], Intervals] = {}
        self._pacing: Dict[Tuple[int, ...], Intervals] = {}

    # -- config-derived scalars ---------------------------------------------
    @property
    def bytes_per_ns(self) -> float:
        return float(self.cfg.get("link_gbps", 100.0)) / 8.0

    @property
    def mtu_bytes(self) -> int:
        return int(self.cfg.get("payload_bytes", 1024)) + \
            int(self.cfg.get("header_bytes", 57))

    @property
    def timeout_ns(self) -> float:
        return float(self.cfg.get("timeout_ns", 1000.0))

    @property
    def retx_timeout_ns(self) -> float:
        return float(self.cfg.get("retx_timeout_ns", 2.0e5))

    @property
    def gbn_timeout_ns(self) -> float:
        return float(self.cfg.get("gbn_timeout_ns", 2.0e5))

    @property
    def num_hosts(self) -> int:
        n = self.meta.get("num_hosts")
        if n:
            return int(n)
        return int(self.cfg.get("num_leaves", 0)) * \
            int(self.cfg.get("hosts_per_leaf", 0))

    @property
    def hops(self) -> int:
        return _TT_HOPS if str(self.cfg.get("topology")) == "three_tier" \
            else _FT_HOPS

    @property
    def wire_estimate_ns(self) -> float:
        """Uncontended time for one block packet to cross the fabric and be
        leader-processed: per-hop serialization + propagation, times the
        topology's host-to-host hop count, plus the host-side leader term."""
        ser = self.mtu_bytes / self.bytes_per_ns
        lat = float(self.cfg.get("hop_latency_ns", 300.0))
        return self.hops * (ser + lat) + \
            float(self.cfg.get("leader_aggregate_ns", 1000.0))

    @property
    def collision_detour_ns(self) -> float:
        """Cost estimate of one §3.2.1 collision: the contribution bypasses
        in-network aggregation, crosses one extra effective hop and must be
        serially host-aggregated at the leader."""
        ser = self.mtu_bytes / self.bytes_per_ns
        return float(self.cfg.get("hop_latency_ns", 300.0)) + ser + \
            float(self.cfg.get("leader_aggregate_ns", 1000.0))

    @property
    def t_end(self) -> float:
        ends = [b.t1 for b in self.blocks()]
        for _, (t, _v) in self.series.items():
            if t:
                ends.append(t[-1])
        return max(ends, default=0.0)

    @property
    def probes_on(self) -> bool:
        return self.summary.get("probes", 0.0) > 0.0

    @property
    def truncated(self) -> bool:
        return bool(self.truncation.get("spans_dropped", 0)
                    or self.truncation.get("samples_dropped", 0)
                    or self.truncation.get("pkt_instants_capped", False))

    @property
    def loss_evidence(self) -> bool:
        """Did the run record any actual packet loss? Block-level retx
        requests fire on a host timer and also trigger under pure
        congestion; without loss evidence they are a *symptom*, so the
        attribution refuses to charge their windows to ``retx_recovery``."""
        if any(s[0] == "drop" for s in self.instants):
            return True
        return any(k.startswith("drops/") and v > 0
                   for k, v in self.counters.items())

    # -- metadata ------------------------------------------------------------
    def apps(self) -> List[int]:
        meta_apps = self.meta.get("apps", {})
        if meta_apps:
            return sorted(int(a) for a in meta_apps)
        return sorted({b.app for b in self.blocks()})

    def participants(self, app: int) -> List[int]:
        info = self.meta.get("apps", {}).get(str(app)) or \
            self.meta.get("apps", {}).get(app) or {}
        return list(info.get("participants", []))

    def tenant_of(self, app: int) -> int:
        info = self.meta.get("apps", {}).get(str(app)) or \
            self.meta.get("apps", {}).get(app) or {}
        t = int(info.get("tenant", -1))
        return t if t >= 0 else app

    def link_name(self, i: int) -> str:
        names = self.meta.get("link_names") or []
        return names[i] if i < len(names) else f"link/{i}"

    # -- reassembled records -------------------------------------------------
    def blocks(self) -> List[BlockRecord]:
        """Block lifecycle records, completed spans first then open ones."""
        if self._blocks is not None:
            return self._blocks
        bcast: Dict[Tuple[int, int], float] = {}
        leader_done: Dict[Tuple[int, int], float] = {}
        leaders: Dict[Tuple[int, int], int] = {}
        for s in self.spans:
            if s[0] == "bcast":
                _, app, block, t0, _t1 = s
                bcast[(int(app), int(block))] = float(t0)
        for s in self.instants:
            if s[0] == "leader_done":
                _, app, block, leader, t = s
                key = (int(app), int(block))
                leader_done.setdefault(key, float(t))
                leaders.setdefault(key, int(leader))
        out: List[BlockRecord] = []
        for s in self.spans:
            if s[0] != "block":
                continue
            _, app, block, t0, t1, last_host = s
            key = (int(app), int(block))
            out.append(BlockRecord(
                app=key[0], block=key[1], t0=float(t0), t1=float(t1),
                last_host=int(last_host),
                bcast_t0=bcast.get(key, leader_done.get(key)),
                leader=leaders.get(key)))
        for ob in self.open_blocks:
            app, block, t0, t_end = ob
            out.append(BlockRecord(app=int(app), block=int(block),
                                   t0=float(t0), t1=float(t_end),
                                   complete=False))
        self._blocks = out
        return out

    def desc_windows(self, app: int, block: int) -> List[DescWindow]:
        if self._desc is None:
            d: Dict[Tuple[int, int], List[DescWindow]] = {}
            for s in self.spans:
                if s[0] != "desc":
                    continue
                _, sw, a, b, reason, merges, _children, t0, t1 = s
                d.setdefault((int(a), int(b)), []).append(DescWindow(
                    sw=int(sw), reason=str(reason), merges=int(merges),
                    t0=float(t0), t1=float(t1)))
            self._desc = d
        return self._desc.get((app, block), [])

    # -- instant streams -----------------------------------------------------
    def retx_instants(self, app: int, block: int) -> List[Tuple[str, float]]:
        """Block-level recovery instants: [(what, t), ...]."""
        return [(s[1], float(s[5])) for s in self.instants
                if s[0] == "retx" and int(s[2]) == app and int(s[4]) == block]

    def gbn_retx_instants(self, hosts: Optional[set] = None
                          ) -> List[Tuple[int, float]]:
        out = []
        for s in self.instants:
            if s[0] == "gbn" and s[1] == "retx":
                host = int(s[2])
                if hosts is None or not hosts or host in hosts:
                    out.append((host, float(s[4])))
        return out

    def collision_instants(self, app: int, block: int) -> List[float]:
        return [float(s[4]) for s in self.instants
                if s[0] in ("collision", "straggler") and s[0] == "collision"
                and int(s[2]) == app and int(s[3]) == block]

    # -- derived interval sets ----------------------------------------------
    def pfc_intervals(self) -> Intervals:
        """Union of PFC pause windows across all paused senders. A pause
        without a matching resume extends to the end of the run."""
        if self._pfc is not None:
            return self._pfc
        open_at: Dict[int, float] = {}
        spans: List[Tuple[float, float]] = []
        t_end = self.t_end
        for s in self.instants:
            if s[0] != "pfc":
                continue
            _, host, paused, t = s
            host, t = int(host), float(t)
            if paused:
                open_at.setdefault(host, t)
            else:
                t0 = open_at.pop(host, None)
                if t0 is not None:
                    spans.append((t0, t))
        spans.extend((t0, t_end) for t0 in open_at.values())
        self._pfc = Intervals(spans)
        return self._pfc

    def fault_intervals(self) -> Intervals:
        """Union of fault-active windows (repro.core.faults): a "fault"
        instant with ``active`` True opens a window keyed by (kind, target),
        its heal (``active`` False) closes it; an unhealed fault extends to
        the end of the run."""
        if self._fault_iv is not None:
            return self._fault_iv
        open_at: Dict[Tuple[str, object], float] = {}
        spans: List[Tuple[float, float]] = []
        t_end = self.t_end
        for s in self.instants:
            if s[0] != "fault":
                continue
            _, kind, target, active, t = s
            key = (str(kind), target)
            if active:
                open_at.setdefault(key, float(t))
            else:
                t0 = open_at.pop(key, None)
                if t0 is not None:
                    spans.append((t0, float(t)))
        spans.extend((t0, t_end) for t0 in open_at.values())
        self._fault_iv = Intervals(spans)
        return self._fault_iv

    def pacing_intervals(self, hosts: Sequence[int]) -> Intervals:
        """Union of the windows during which any of ``hosts`` was DCQCN-paced
        below line rate (from the per-host ``rate_gbps`` probe series)."""
        key = tuple(sorted(hosts))
        cached = self._pacing.get(key)
        if cached is not None:
            return cached
        line = float(self.cfg.get("link_gbps", 100.0))
        thresh = -(line * (1.0 - 1e-9))   # v > thresh  <=>  rate < line
        t_end = self.t_end
        acc = Intervals()
        for h in key:
            s = self.series.get(f"host/{h}/rate_gbps")
            if not s or not s[0]:
                continue
            t, v = s
            acc = acc.union(step_intervals_above(
                t, [-x for x in v], thresh, t_end))
        self._pacing[key] = acc
        return acc

    def congested_intervals(self, thresh_bytes: Optional[float] = None
                            ) -> Intervals:
        """Windows during which the most-backlogged fabric link held more
        than ``thresh_bytes`` (default: one MTU) of queued bytes."""
        if thresh_bytes is None and self._congested is not None:
            return self._congested
        s = self.series.get("net/backlog_max_bytes")
        if not s or not s[0]:
            return Intervals()
        thr = float(self.mtu_bytes if thresh_bytes is None else thresh_bytes)
        out = step_intervals_above(s[0], s[1], thr, self.t_end)
        if thresh_bytes is None:
            self._congested = out
        return out

    def app_congested_intervals(self, participants: Sequence[int]
                                ) -> Intervals:
        """Congested windows on links that can actually carry this app's
        traffic: the participants' own host links plus every fabric link
        (leaf/spine/agg/core). Host links of *other* hosts — e.g.
        background-traffic sinks — are excluded: their queues cannot delay
        this app, and charging their backlog would misattribute bystander
        congestion. Falls back to the global signal when no participant set
        is known."""
        key = tuple(sorted(participants))
        if not key:
            return self.congested_intervals()
        cached = self._app_congested.get(key)
        if cached is not None:
            return cached
        n = self.num_hosts
        relevant = set(key) | {n + p for p in key}
        thr = float(self.mtu_bytes)
        spans: List[Tuple[float, float]] = []
        for name, (t, v) in self.series.items():
            if not (name.startswith("link/")
                    and name.endswith("/backlog_bytes")) or not t:
                continue
            idx = int(name.split("/")[1])
            if idx < 2 * n and idx not in relevant:
                continue
            spans.extend(
                step_intervals_above(t, v, thr, self.t_end).spans)
        out = Intervals(spans)
        self._app_congested[key] = out
        return out

    def link_congested_intervals(self, link: int,
                                 thresh_bytes: Optional[float] = None
                                 ) -> Intervals:
        """Windows during which one specific link held more than
        ``thresh_bytes`` (default: one MTU) of queued bytes."""
        s = self.series.get(f"link/{link}/backlog_bytes")
        if not s or not s[0]:
            return Intervals()
        thr = float(self.mtu_bytes if thresh_bytes is None else thresh_bytes)
        return step_intervals_above(s[0], s[1], thr, self.t_end)


# ------------------------------------------------------------- constructors
def view_of(tel) -> RunView:
    """Build a :class:`RunView` from a finished live telemetry hub."""
    import dataclasses
    cfg = dataclasses.asdict(tel.cfg)
    series = {name: (list(ts.t), list(ts.v))
              for name, ts in tel.registry.series.items()}
    return RunView(cfg=cfg, meta=getattr(tel, "meta", {}) or {},
                   spans=[tuple(s) for s in tel.spans],
                   instants=[tuple(s) for s in tel.instants],
                   open_blocks=[tuple(b) for b in
                                getattr(tel, "open_blocks", [])],
                   series=series, counters=dict(tel.registry.counters),
                   summary=tel.summary_dict(),
                   truncation=tel.truncation_dict())


def load_dump(path_or_doc) -> RunView:
    """Build a :class:`RunView` from ``export.write_dump`` output (a path or
    an already-loaded document)."""
    if isinstance(path_or_doc, (str, bytes)):
        with open(path_or_doc) as f:
            doc = json.load(f)
    else:
        doc = path_or_doc
    version = doc.get("version")
    if version != 1:
        raise ValueError(f"unsupported telemetry dump version {version!r}")
    series = {name: (list(s["t"]), list(s["v"]))
              for name, s in doc.get("series", {}).items()}
    return RunView(cfg=doc.get("cfg", {}), meta=doc.get("meta", {}),
                   spans=[tuple(s) for s in doc.get("spans", [])],
                   instants=[tuple(s) for s in doc.get("instants", [])],
                   open_blocks=[tuple(b) for b in
                                doc.get("open_blocks", [])],
                   series=series, counters=doc.get("counters", {}),
                   summary=doc.get("summary", {}),
                   truncation=doc.get("truncation", {}))


# ------------------------------------------------------------ critical path
def critical_path(view: RunView, app: int) -> List[PathSegment]:
    """Backward critical-path walk over ``app``'s block spans.

    Partitions the job makespan ``[min t0, max t1]`` into segments, each
    owned by the block that was the *latest-finishing active cover* at that
    time (walking backward from the finish, always extending with the
    covering block whose span reaches furthest back). Time no block span
    covers becomes an explicit idle segment (``block is None``). Segment
    lengths sum to the makespan exactly — the job-level half of the
    conservation contract.
    """
    blocks = [b for b in view.blocks() if b.app == app]
    if not blocks:
        return []
    job_t0 = min(b.t0 for b in blocks)
    job_t1 = max(b.t1 for b in blocks)
    segments: List[PathSegment] = []
    cur = job_t1
    remaining = sorted(blocks, key=lambda b: b.t1, reverse=True)
    eps = 1e-9
    while cur > job_t0 + eps:
        covering = [b for b in remaining if b.t0 < cur and b.t1 >= cur - eps]
        if covering:
            best = min(covering, key=lambda b: b.t0)
            segments.append(PathSegment(t0=best.t0, t1=cur, block=best))
            cur = best.t0
        else:
            earlier = [b for b in remaining if b.t1 < cur]
            gap_to = max((b.t1 for b in earlier), default=job_t0)
            segments.append(PathSegment(t0=gap_to, t1=cur, block=None))
            cur = gap_to
    segments.reverse()
    return segments


def job_interval(view: RunView, app: int) -> Optional[Tuple[float, float]]:
    blocks = [b for b in view.blocks() if b.app == app]
    if not blocks:
        return None
    return (min(b.t0 for b in blocks), max(b.t1 for b in blocks))


# ----------------------------------------------------------------- hotspots
def hotspots(view: RunView, window: Optional[Intervals] = None,
             top: Optional[int] = None) -> List[Hotspot]:
    """Rank fabric links by their time-averaged queueing delay over
    ``window`` (default: the whole run). The score is the mean extra delay a
    packet crossing that link during the window would have seen —
    ``∫ backlog(t) dt / (bytes_per_ns · |window|)`` — which is exactly the
    per-link utilization signal SOAR-style bounded placement consumes."""
    if window is None:
        window = Intervals([(0.0, max(view.t_end, 1e-9))])
    dur = window.measure()
    if dur <= 0.0:
        return []
    bpn = view.bytes_per_ns
    out: List[Hotspot] = []
    for name, (t, v) in view.series.items():
        if not name.startswith("link/") or not name.endswith("/backlog_bytes"):
            continue
        if not t:
            continue
        idx = int(name.split("/")[1])
        integral = 0.0
        for a, b in window.spans:
            integral += step_integral(t, v, a, b)
        busy_iv = step_intervals_above(t, v, 0.0, view.t_end)
        busy = busy_iv.intersect(window).measure()
        # peak over the window only: each sample holds on [t[i], t[i+1])
        peak = 0.0
        for i, vi in enumerate(v):
            seg = Intervals([(t[i], t[i + 1] if i + 1 < len(t)
                              else max(view.t_end, t[i] + 1e-9))])
            if vi > peak and not seg.intersect(window).is_empty():
                peak = vi
        if integral <= 0.0 and peak <= 0.0:
            continue
        out.append(Hotspot(link=idx, name=view.link_name(idx),
                           mean_queue_ns=integral / (bpn * dur),
                           peak_backlog_bytes=peak,
                           busy_frac=busy / dur))
    out.sort(key=lambda h: h.mean_queue_ns, reverse=True)
    return out[:top] if top else out
