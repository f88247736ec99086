"""Fleet driver: one multi-tenant, open-loop simulation end to end.

Glues the fleet pieces onto the ``Simulator`` facade:

1. a :class:`FleetScenario` (topology config + tenants + arrival-timed jobs
   + quota policy),
2. an :class:`~repro.core.fleet.quota.AdmissionController` built from it,
3. one ``Simulator`` run with open-loop ``EV_JOB_ARRIVE`` activations,
4. optional per-job *uncontended* baseline runs (the same job alone on an
   idle fabric, no quotas) to turn JCTs into slowdowns,
5. a :class:`FleetResult` with per-job records, per-tenant aggregates and
   Jain's fairness index.

Baselines are cached by job shape — a training tenant re-running the same
placement every iteration costs one baseline simulation, not one per job.
"""
from __future__ import annotations

import dataclasses
import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..canary.simulator import Simulator
from ..canary.types import (Algo, AllreduceJob, SimConfig, SimResult,
                            TenantSpec)
from .metrics import (JobRecord, job_records, per_tenant_means,
                      per_tenant_percentiles, percentile, tenant_fairness)
from .quota import AdmissionController


@dataclass
class FleetScenario:
    """Everything one fleet run needs. ``jobs`` carry their own
    ``arrival_ns``/``tenant``; every job's tenant must appear in ``tenants``
    unless the quota policy is ``"none"``."""

    cfg: SimConfig
    tenants: List[TenantSpec]
    jobs: List[AllreduceJob]
    algo: Algo = Algo.CANARY
    n_trees: int = 1
    noise_hosts: Optional[List[int]] = None
    quota_policy: str = "weighted"     # none | equal | weighted
    overflow: str = "degrade"          # degrade | defer
    baselines: bool = True             # run uncontended JCTs for slowdown
    demand_slots: Optional[int] = None  # override the Little's-law demand


@dataclass
class FleetResult:
    """Outputs of one fleet run."""

    sim: SimResult
    jobs: List[JobRecord]
    admission: AdmissionController
    mean_jct_ns: float
    max_jct_ns: float
    mean_slowdown: Optional[float]     # None when baselines were off
    jain_fairness: float               # across tenants (see metrics.py)
    degraded_jobs: int
    deferred_jobs: int
    # fleet-wide JCT tail (linear-interpolation percentiles over all jobs);
    # NaN when no job finished. Per-tenant tails live in ``per_tenant``.
    p50_jct_ns: float = float("nan")
    p99_jct_ns: float = float("nan")
    per_tenant: Dict[int, dict] = field(default_factory=dict)
    # tenant -> [(t_ns, blocks_in_flight)], present only when the scenario's
    # cfg enabled telemetry (merged from the hub's per-app probe series)
    tenant_series: Dict[int, List[Tuple[float, float]]] = \
        field(default_factory=dict)
    # full run diagnosis (repro.core.telemetry.attribution.Diagnosis):
    # per-tenant cause attribution + hotspot ranking, present only when the
    # scenario's cfg enabled telemetry — a tenant's p99 traced to causes
    # and to the fabric links responsible (ARCHITECTURE.md §Diagnosis)
    diagnosis: Optional[object] = None
    # survivability aggregates (repro.core.faults), trivial without a fault
    # schedule (survival_rate 1.0, zero recovery): fraction of jobs that
    # completed, mean/max post-heal recovery tails, and the injected
    # fault/heal event log from the underlying ``SimResult``
    survival_rate: float = 1.0
    mean_recovery_ns: float = 0.0
    max_recovery_ns: float = 0.0
    fault_events: List[dict] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.sim.correct

    def summary(self) -> str:
        sd = f"{self.mean_slowdown:.2f}" if self.mean_slowdown is not None \
            else "n/a"
        return (f"jobs={len(self.jobs)} correct={self.correct} "
                f"mean_jct={self.mean_jct_ns/1e3:.1f}us "
                f"p50={self.p50_jct_ns/1e3:.1f}us "
                f"p99={self.p99_jct_ns/1e3:.1f}us slowdown={sd} "
                f"jain={self.jain_fairness:.3f} degraded={self.degraded_jobs} "
                f"deferred={self.deferred_jobs}")


class FleetDriver:
    """Build and run one :class:`FleetScenario`."""

    def __init__(self, scenario: FleetScenario):
        self.scenario = scenario
        self._baseline_cache: Dict[Tuple, float] = {}

    # ----------------------------------------------------------- construction
    def make_admission(self) -> AdmissionController:
        s = self.scenario
        return AdmissionController(s.tenants, policy=s.quota_policy,
                                   overflow=s.overflow, demand=s.demand_slots)

    def build_simulator(self) -> Simulator:
        s = self.scenario
        return Simulator(s.cfg, s.jobs, algo=s.algo, n_trees=s.n_trees,
                         noise_hosts=s.noise_hosts,
                         admission=self.make_admission())

    # ------------------------------------------------------------- baselines
    def _baseline_jct(self, job: AllreduceJob) -> float:
        """Uncontended JCT of ``job``: same fabric/algo, alone, at t=0, no
        quotas, no background noise."""
        s = self.scenario
        key = (tuple(sorted(job.participants)), job.data_bytes,
               job.collective, job.root)
        cached = self._baseline_cache.get(key)
        if cached is not None:
            return cached
        solo = dataclasses.replace(job, arrival_ns=0.0, tenant=-1)
        sim = Simulator(s.cfg, [solo], algo=s.algo, n_trees=s.n_trees)
        jct = sim.run().duration_ns
        self._baseline_cache[key] = jct
        return jct

    # -------------------------------------------------------------------- run
    def run(self) -> FleetResult:
        s = self.scenario
        sim = self.build_simulator()
        result = sim.run()
        baselines = None
        if s.baselines:
            baselines = {j.app: self._baseline_jct(j) for j in s.jobs
                         if len(j.participants) > 1}
        records = job_records(result, baselines)
        admission = sim.admission
        jcts = [r.jct_ns for r in records if r.jct_ns == r.jct_ns]
        slowdowns = [r.slowdown for r in records if r.slowdown is not None]
        mean_jct_by_tenant = per_tenant_means(records, "jct_ns")
        mean_sd_by_tenant = per_tenant_means(records, "slowdown")
        jct_pcts = per_tenant_percentiles(records, "jct_ns")
        sd_pcts = per_tenant_percentiles(records, "slowdown")
        per_tenant: Dict[int, dict] = {}
        for t in sorted({r.tenant for r in records}):
            trs = [r for r in records if r.tenant == t]
            jp = jct_pcts.get(t, {})
            sp = sd_pcts.get(t, {})
            per_tenant[t] = {
                "jobs": len(trs),
                "mean_jct_ns": mean_jct_by_tenant.get(t, float("nan")),
                "mean_slowdown": mean_sd_by_tenant.get(t),
                "p50_jct_ns": jp.get("p50", float("nan")),
                "p99_jct_ns": jp.get("p99", float("nan")),
                "p50_slowdown": sp.get("p50"),
                "p99_slowdown": sp.get("p99"),
                "degraded_jobs": sum(1 for r in trs if not r.admitted),
                "fallback_blocks": sum(r.fallback_blocks for r in trs),
            }
        diag = None
        if sim.telemetry is not None:
            # lazy import: the fleet layer only pulls in the diagnosis
            # machinery when a run actually recorded telemetry
            from ..telemetry import diagnose, view_of
            diag = diagnose(view_of(sim.telemetry))
        return FleetResult(
            sim=result,
            jobs=records,
            admission=admission,
            mean_jct_ns=statistics.mean(jcts) if jcts else float("nan"),
            max_jct_ns=max(jcts) if jcts else float("nan"),
            mean_slowdown=statistics.mean(slowdowns) if slowdowns else None,
            jain_fairness=tenant_fairness(records),
            degraded_jobs=sum(1 for r in records if not r.admitted),
            deferred_jobs=len(admission.deferrals) if admission else 0,
            p50_jct_ns=percentile(jcts, 50.0) if jcts else float("nan"),
            p99_jct_ns=percentile(jcts, 99.0) if jcts else float("nan"),
            per_tenant=per_tenant,
            tenant_series=(tenant_remaining_series(sim, s.jobs)
                           if sim.telemetry is not None else {}),
            diagnosis=diag,
            survival_rate=(sum(result.survived.values())
                           / len(result.survived)
                           if result.survived else 1.0),
            mean_recovery_ns=(statistics.mean(result.fault_recovery_ns
                                              .values())
                              if result.fault_recovery_ns else 0.0),
            max_recovery_ns=(max(result.fault_recovery_ns.values())
                             if result.fault_recovery_ns else 0.0),
            fault_events=list(result.fault_events),
        )


def tenant_remaining_series(sim, jobs) -> Dict[int, List[Tuple[float, float]]]:
    """Merge the telemetry hub's per-app ``app/{app}/remaining`` probe series
    into one step-summed blocks-in-flight series per tenant.

    Each app series is a step function (delta-encoded); the merge walks the
    union of their timestamps carrying each app's last value, so the sum is
    exact at every recorded point. The merged series are also written back
    into the hub registry as ``tenant/{t}/remaining`` so the exporters emit
    them alongside the raw per-app tracks."""
    reg = sim.telemetry.registry
    by_tenant: Dict[int, list] = {}
    for j in jobs:
        ts = reg.series.get(f"app/{j.app}/remaining")
        if ts is None:
            continue
        t = j.tenant if j.tenant >= 0 else j.app
        by_tenant.setdefault(t, []).append(ts)
    out: Dict[int, List[Tuple[float, float]]] = {}
    for t, series in sorted(by_tenant.items()):
        stamps = sorted({tt for ts in series for tt in ts.t})
        idx = [0] * len(series)
        last = [0.0] * len(series)
        merged: List[Tuple[float, float]] = []
        for tt in stamps:
            for k, ts in enumerate(series):
                while idx[k] < len(ts.t) and ts.t[idx[k]] <= tt:
                    last[k] = ts.v[idx[k]]
                    idx[k] += 1
            total = sum(last)
            if not merged or merged[-1][1] != total:
                merged.append((tt, total))
        out[t] = merged
        hub_ts = reg.ts(f"tenant/{t}/remaining")
        for tt, v in merged:
            hub_ts.record(tt, v)
    return out


def run_fleet(scenario: FleetScenario) -> FleetResult:
    """One-call convenience wrapper."""
    return FleetDriver(scenario).run()
