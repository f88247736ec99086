"""Per-job QoS metrics for fleet runs: JCT, slowdown, Jain fairness.

``SimResult`` carries the raw lifecycle stamps (submit/start/finish per app);
this module turns them into the numbers multi-tenant papers compare on:

* **JCT** — job completion time, ``finish - submit`` (includes any deferral
  wait imposed by admission control).
* **slowdown** — JCT divided by the same job's *uncontended* JCT (alone on
  the fabric, no quotas); 1.0 means sharing cost the tenant nothing.
* **Jain's fairness index** — ``(Σx)² / (n·Σx²)`` over per-tenant mean
  slowdowns: 1.0 when every tenant suffers equally, ``1/n`` when one tenant
  absorbs all the contention.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..canary.types import SimResult


def jain_index(values: Sequence[float]) -> float:
    """Jain's fairness index over ``values`` (1.0 = perfectly fair)."""
    vals = [float(v) for v in values]
    if not vals:
        return 1.0
    s = sum(vals)
    s2 = sum(v * v for v in vals)
    if s2 <= 0.0:
        return 1.0
    return (s * s) / (len(vals) * s2)


@dataclass(frozen=True)
class JobRecord:
    """One job's lifecycle, flattened from a fleet ``SimResult``."""

    app: int
    tenant: int
    submit_ns: float
    start_ns: float        # admission time (> submit when the job was deferred)
    finish_ns: float
    jct_ns: float
    admitted: bool         # False: degraded to the §3.3 host-based path
    fallback_blocks: int
    slowdown: Optional[float] = None  # vs uncontended run; None w/o baseline

    @property
    def wait_ns(self) -> float:
        """Queueing delay imposed by admission control."""
        return self.start_ns - self.submit_ns


def job_records(result: SimResult,
                baselines: Optional[Dict[int, float]] = None
                ) -> List[JobRecord]:
    """Flatten ``result``'s per-job stamps; ``baselines`` maps app ->
    uncontended JCT in ns (for slowdown)."""
    out = []
    for app in sorted(result.job_submit_ns):
        submit = result.job_submit_ns[app]
        finish = result.job_finish_ns.get(app, float("nan"))
        jct = finish - submit
        base = (baselines or {}).get(app)
        out.append(JobRecord(
            app=app,
            tenant=result.tenant_of.get(app, app),
            submit_ns=submit,
            start_ns=result.job_start_ns.get(app, submit),
            finish_ns=finish,
            jct_ns=jct,
            admitted=result.job_admitted.get(app, True),
            fallback_blocks=result.app_fallback_blocks.get(app, 0),
            slowdown=(jct / base) if base else None,
        ))
    return out


def per_tenant_means(records: Sequence[JobRecord],
                     attr: str = "slowdown") -> Dict[int, float]:
    """tenant -> mean of ``attr`` over its jobs (jobs missing the attr are
    skipped; tenants with no usable jobs are dropped)."""
    by_tenant: Dict[int, List[float]] = {}
    for r in records:
        v = getattr(r, attr)
        if v is None or v != v:
            continue
        by_tenant.setdefault(r.tenant, []).append(float(v))
    return {t: statistics.mean(vs) for t, vs in by_tenant.items()}


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) with linear interpolation between
    closest ranks — numpy's default method, hand-rolled so the fleet layer
    stays dependency-free. Raises on an empty sequence."""
    if not values:
        raise ValueError("percentile of empty sequence")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    vs = sorted(float(v) for v in values)
    if len(vs) == 1:
        return vs[0]
    rank = (q / 100.0) * (len(vs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(vs) - 1)
    frac = rank - lo
    return vs[lo] * (1.0 - frac) + vs[hi] * frac


def per_tenant_percentiles(records: Sequence[JobRecord],
                           attr: str = "jct_ns",
                           qs: Sequence[float] = (50.0, 99.0)
                           ) -> Dict[int, Dict[str, float]]:
    """tenant -> {"p50": ..., "p99": ...} over ``attr`` of its jobs — the
    user-facing latency numbers a serving fleet is judged on (a tenant's
    p99 JCT is what its own SLO sees; the mean hides the tail). Jobs
    missing the attr are skipped, tenants with no usable jobs dropped."""
    by_tenant: Dict[int, List[float]] = {}
    for r in records:
        v = getattr(r, attr)
        if v is None or v != v:
            continue
        by_tenant.setdefault(r.tenant, []).append(float(v))
    return {t: {f"p{q:g}": percentile(vs, q) for q in qs}
            for t, vs in by_tenant.items()}


def tenant_fairness(records: Sequence[JobRecord]) -> float:
    """Jain's index over per-tenant mean slowdowns (falls back to mean JCTs
    when no baselines were run)."""
    means = per_tenant_means(records, "slowdown")
    if not means:
        means = per_tenant_means(records, "jct_ns")
    return jain_index(list(means.values()))
