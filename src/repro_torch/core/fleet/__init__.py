"""Fleet subsystem: multi-tenant in-network allreduce at datacenter scale.

Layered on the :class:`~repro.core.canary.Simulator` facade (see
``ARCHITECTURE.md``, "Fleet subsystem"):

* :mod:`~.arrivals` — open-loop workload generation (Poisson / periodic
  training iterations / bursty traces) feeding ``EV_JOB_ARRIVE`` events.
* :mod:`~.quota`    — **enforced** descriptor-table budgets: per-tenant slot
  regions derived from the §3.2.2 occupancy model, weighted sharing, and
  admission control that degrades (§3.3 host-based path) or defers jobs.
* :mod:`~.metrics`  — per-job JCT / slowdown and Jain's fairness index.
* :mod:`~.driver`   — :class:`FleetDriver`: scenario in, :class:`FleetResult`
  (with uncontended-baseline slowdowns) out.

The layer is pay-for-what-you-use: a run without an admission controller —
or with ``quota_policy="none"`` — is bit-identical to the plain simulator
(pinned by ``tests/fleet/test_golden_compat.py``).
"""
from ..canary.types import AllreduceJob, TenantSpec
from .arrivals import (bursty_arrivals, make_jobs, periodic_arrivals,
                       poisson_arrivals, trace_arrivals)
from .driver import FleetDriver, FleetResult, FleetScenario, run_fleet
from .metrics import (JobRecord, jain_index, job_records, per_tenant_means,
                      tenant_fairness)
from .quota import (ADMIT, DEFER, DEGRADE, AdmissionController, demand_slots,
                    model_diameter)

__all__ = [
    "ADMIT", "DEFER", "DEGRADE", "AdmissionController", "AllreduceJob",
    "FleetDriver", "FleetResult", "FleetScenario", "JobRecord", "TenantSpec",
    "bursty_arrivals", "demand_slots", "jain_index", "job_records",
    "make_jobs", "model_diameter", "per_tenant_means", "periodic_arrivals",
    "poisson_arrivals", "run_fleet", "tenant_fairness", "trace_arrivals",
]
