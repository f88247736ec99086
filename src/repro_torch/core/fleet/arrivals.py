"""Open-loop workload generation: when do tenants submit jobs?

The seed simulator only ran closed-loop fleets — every job present at t=0.
Datacenter tenants submit *over time* (Flare, Segal et al.), so the fleet
subsystem generates arrival times and turns them into
:class:`~repro.core.canary.types.AllreduceJob` lists whose ``arrival_ns``
becomes a first-class engine event (``EV_JOB_ARRIVE``).

Three arrival processes cover the paper-adjacent scenarios:

* :func:`poisson_arrivals`  — memoryless open-loop submissions (the classic
  datacenter arrival model).
* :func:`periodic_arrivals` — a training tenant issuing one allreduce per
  iteration, with optional jitter.
* :func:`bursty_arrivals`   — trace-like bursts: ``burst_size`` near-simultaneous
  submissions separated by quiet gaps.

All generators take an explicit ``random.Random`` so fleet scenarios stay
bit-reproducible, and return sorted absolute times in nanoseconds.
"""
from __future__ import annotations

import random
from typing import List, Optional, Sequence

from ..canary.types import AllreduceJob, TenantSpec


def poisson_arrivals(n_jobs: int, mean_interarrival_ns: float, *,
                     rng: random.Random, start_ns: float = 0.0) -> List[float]:
    """``n_jobs`` Poisson-process submit times (exponential interarrivals)."""
    if n_jobs < 0 or mean_interarrival_ns <= 0:
        raise ValueError("need n_jobs >= 0 and mean_interarrival_ns > 0")
    t, out = start_ns, []
    for _ in range(n_jobs):
        t += rng.expovariate(1.0 / mean_interarrival_ns)
        out.append(t)
    return out


def periodic_arrivals(n_jobs: int, period_ns: float, *, start_ns: float = 0.0,
                      jitter_ns: float = 0.0,
                      rng: Optional[random.Random] = None) -> List[float]:
    """Training-iteration arrivals: one job per ``period_ns``, plus uniform
    jitter in ``[0, jitter_ns)`` (requires ``rng`` when jitter is on)."""
    if jitter_ns > 0.0 and rng is None:
        raise ValueError("jitter_ns > 0 needs an rng")
    out = []
    for i in range(n_jobs):
        t = start_ns + i * period_ns
        if jitter_ns > 0.0:
            t += rng.random() * jitter_ns
        out.append(t)
    return sorted(out)


def bursty_arrivals(n_bursts: int, burst_size: int, burst_gap_ns: float, *,
                    start_ns: float = 0.0,
                    intra_burst_ns: float = 0.0) -> List[float]:
    """Trace-driven-style bursts: ``burst_size`` jobs ``intra_burst_ns`` apart,
    bursts separated by ``burst_gap_ns``."""
    out = []
    for b in range(n_bursts):
        t0 = start_ns + b * burst_gap_ns
        out.extend(t0 + j * intra_burst_ns for j in range(burst_size))
    return out


def trace_arrivals(times_ns: Sequence[float]) -> List[float]:
    """Explicit submit times (e.g. replayed from a production trace)."""
    out = sorted(float(t) for t in times_ns)
    if out and out[0] < 0:
        raise ValueError("arrival times must be >= 0")
    return out


def make_jobs(tenant: TenantSpec, arrivals: Sequence[float],
              host_pool: Sequence[int], hosts_per_job: int,
              data_bytes: int, *, rng: random.Random, app_base: int,
              fixed_placement: bool = True,
              collective: str = "allreduce") -> List[AllreduceJob]:
    """Turn arrival times into a tenant's job list.

    ``fixed_placement=True`` models a training tenant: every iteration runs
    over the same ``hosts_per_job``-host sample from the tenant's pool.
    ``False`` re-samples placement per job (batch/inference tenants). App ids
    are ``app_base, app_base+1, ...`` — the caller keeps them fleet-unique.
    """
    if hosts_per_job < 2 or hosts_per_job > len(host_pool):
        raise ValueError(f"hosts_per_job={hosts_per_job} outside "
                         f"[2, {len(host_pool)}] for tenant {tenant.tenant}")
    placement = rng.sample(list(host_pool), hosts_per_job)
    jobs = []
    for i, t in enumerate(arrivals):
        if not fixed_placement:
            placement = rng.sample(list(host_pool), hosts_per_job)
        jobs.append(AllreduceJob(app=app_base + i, participants=list(placement),
                                 data_bytes=data_bytes, collective=collective,
                                 arrival_ns=float(t), tenant=tenant.tenant))
    return jobs
