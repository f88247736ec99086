"""Enforced switch-memory quotas + admission control (§3.2.2, §3.3).

The paper argues descriptor memory is the scarce switch resource bounding how
many tenants can aggregate in-network at once. The seed repo had the analytic
:class:`~repro.core.canary.memory_model.OccupancyModel` but the dataplane
never enforced it. This module closes that loop:

* :func:`demand_slots` converts the Little's-law occupancy bound into the
  number of descriptor slots one running job needs per switch.
* :class:`AdmissionController` carves the descriptor table into per-tenant
  slot *regions* (policy-weighted) and, at every job arrival, converts the
  tenant's region into a concurrency budget ``region_slots // demand``.

For CANARY, enforcement is physical, not advisory: an admitted app's
descriptors hash only within its tenant's region
(``CanaryStrategy.slot_of``), so a tenant can never occupy more slots per
switch than its quota — overload inside the region collides and bypasses
(§3.2.1) rather than stealing neighbours' slots. Jobs beyond the concurrency
budget are **degraded** to the §3.3 host-based path (bypass packets, leader
unicasts the result) or **deferred** until a running job of the same tenant
finishes.

STATIC_TREE has no slot-hashed table (descriptors follow the configured
plan, which has no §3.2.1 collision/bypass escape hatch a full region could
fall back on), so for it the quota acts as the admission-level concurrency
budget only — the per-switch footprint of an *admitted* static-tree job is
bounded by its blocks in flight, not by the region. Host-based strategies
(``uses_switch_memory = False``, e.g. RING) consume no descriptors and are
always admitted without a region.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Set, Tuple

from ..canary.memory_model import OccupancyModel, model_for
from ..canary.types import SimConfig, TenantSpec

# admission decisions (returned by AdmissionController.on_job_arrival)
ADMIT = "admit"
DEGRADE = "degrade"
DEFER = "defer"

POLICIES = ("none", "equal", "weighted")
OVERFLOW = ("degrade", "defer")


def model_diameter(cfg: SimConfig) -> int:
    """Switch-depth used for the occupancy model of ``cfg``'s topology."""
    return 3 if cfg.topology == "three_tier" else 2


def demand_slots(cfg: SimConfig,
                 model: Optional[OccupancyModel] = None) -> int:
    """Descriptor slots one in-network job needs per switch.

    Little's law (§3.2.2): ``occupancy_bytes`` of descriptor state are in
    flight per switch per allreduce; at one MTU-sized block per descriptor
    that is ``occupancy_bytes / mtu_bytes`` slots, independent of the reduced
    data size and the host count.
    """
    if model is None:
        model = model_for(cfg, diameter=model_diameter(cfg))
    return max(1, math.ceil(model.occupancy_bytes / cfg.mtu_bytes))


class AdmissionController:
    """Per-tenant descriptor-table budgets, installed on a ``Simulator``.

    Pass as ``Simulator(..., admission=controller)``. The facade calls
    :meth:`on_job_arrival` when a job activates (t=0 or its ``EV_JOB_ARRIVE``)
    and :meth:`on_job_done` when its last block completes. ``policy='none'``
    admits everything with no regions — attached but inert, which is what the
    golden-compat tests pin.
    """

    def __init__(self, tenants: List[TenantSpec], *, policy: str = "weighted",
                 overflow: str = "degrade",
                 demand: Optional[int] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown quota policy {policy!r}; have {POLICIES}")
        if overflow not in OVERFLOW:
            raise ValueError(f"unknown overflow action {overflow!r}; "
                             f"have {OVERFLOW}")
        seen = [t.tenant for t in tenants]
        if len(set(seen)) != len(seen):
            raise ValueError(f"duplicate tenant ids: {sorted(seen)}")
        self.tenants = list(tenants)
        self.policy = policy
        self.overflow = overflow
        self.demand_override = demand
        # filled by attach()
        self.demand = 0
        self.regions: Dict[int, Tuple[int, int]] = {}   # tenant -> (off, size)
        self.caps: Dict[int, int] = {}                  # tenant -> max concurrent
        # runtime state
        self.running: Dict[int, Set[int]] = {}          # tenant -> running apps
        self.deferred: Dict[int, List[int]] = {}        # tenant -> FIFO of apps
        self.decisions: Dict[int, str] = {}             # app -> final decision
        self.deferrals: Dict[int, int] = {}             # app -> times deferred

    # ------------------------------------------------------------------ setup
    def attach(self, sim) -> "AdmissionController":
        """Derive per-tenant regions/budgets from ``sim.cfg`` (called by the
        ``Simulator`` constructor)."""
        cfg = sim.cfg
        self.demand = self.demand_override or demand_slots(cfg)
        self.regions.clear()
        self.caps.clear()
        # reset runtime state so one controller can serve consecutive runs
        self.running.clear()
        self.deferred.clear()
        self.decisions.clear()
        self.deferrals.clear()
        if self.policy == "none":
            return self
        total_w = sum(t.weight for t in self.tenants)
        if total_w <= 0:
            raise ValueError("tenant weights must sum > 0")
        offset = 0
        for t in sorted(self.tenants, key=lambda t: t.tenant):
            share = (t.weight / total_w) if self.policy == "weighted" \
                else 1.0 / len(self.tenants)
            size = max(1, int(cfg.table_size * share))
            size = min(size, cfg.table_size - offset)
            if size <= 0:
                raise ValueError("descriptor table too small for the tenant "
                                 f"set (table_size={cfg.table_size})")
            self.regions[t.tenant] = (offset, size)
            self.caps[t.tenant] = size // self.demand
            offset += size
        return self

    # ------------------------------------------------------------ admission
    def on_job_arrival(self, sim, app: int, job) -> str:
        tenant = sim.tenant_of[app]
        if self.policy == "none" or not sim.strategy.uses_switch_memory:
            self.decisions[app] = ADMIT
            return ADMIT
        if tenant not in self.regions:
            raise ValueError(f"app {app} belongs to unknown tenant {tenant}; "
                             f"configured: {sorted(self.regions)}")
        running = self.running.setdefault(tenant, set())
        if len(running) < self.caps[tenant]:
            running.add(app)
            sim.slot_regions[app] = self.regions[tenant]
            self.decisions[app] = ADMIT
            return ADMIT
        if self.overflow == "defer" and running:
            # a running job of this tenant will finish and retry us; with an
            # empty running set (cap == 0) deferring would deadlock, so the
            # job degrades instead
            self.deferred.setdefault(tenant, []).append(app)
            self.deferrals[app] = self.deferrals.get(app, 0) + 1
            self.decisions[app] = DEFER
            return DEFER
        self.decisions[app] = DEGRADE
        return DEGRADE

    def on_job_done(self, sim, app: int) -> None:
        if self.policy == "none":
            return
        tenant = sim.tenant_of.get(app, app)
        running = self.running.get(tenant)
        if running is None or app not in running:
            return  # degraded/deferred jobs held no slots
        running.discard(app)
        queue = self.deferred.get(tenant)
        if queue:
            # exactly one slot freed -> retry exactly one deferred job
            sim._activate_job(queue.pop(0))

    def release(self, sim, app: int) -> None:
        """Free a still-running app's quota slot mid-run (repro.core.faults):
        when a fault escalates ``app`` to the host-based fallback it stops
        consuming switch memory, so its slot can re-admit one deferred job
        immediately instead of waiting for the degraded app to finish.
        ``on_job_done`` later finds the slot already released and no-ops."""
        if self.policy == "none":
            return
        tenant = sim.tenant_of.get(app, app)
        running = self.running.get(tenant)
        if running is None or app not in running:
            return
        running.discard(app)
        sim.slot_regions.pop(app, None)
        queue = self.deferred.get(tenant)
        if queue:
            sim._activate_job(queue.pop(0))

    # ------------------------------------------------------------ inspection
    def degraded_apps(self) -> Set[int]:
        return {a for a, d in self.decisions.items() if d == DEGRADE}

    def region_of(self, tenant: int) -> Optional[Tuple[int, int]]:
        return self.regions.get(tenant)

    def summary(self) -> str:
        per = " ".join(
            f"t{t.tenant}[slots={self.regions.get(t.tenant, (0, 0))[1]} "
            f"cap={self.caps.get(t.tenant, 'inf')}]"
            for t in sorted(self.tenants, key=lambda t: t.tenant))
        return (f"policy={self.policy} overflow={self.overflow} "
                f"demand={self.demand} slots/job {per}")
