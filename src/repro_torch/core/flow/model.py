"""Lower one experiment cell to a flow-level bandwidth-sharing problem.

One sweep work item (same dict schema as ``benchmarks/sweep.py`` /
``repro.core.canary.backends``) becomes one :class:`FlowCell`: a small set
of *modeled links* — the per-leaf fabric links the allreduce actually
crosses, each with a foreground byte load and a background noise demand —
plus the scalar pipe/tail terms. The solver (``batch.py``) then evaluates

    T_bw  = max over links of  load / (C * max(1 - kappa*g, floor))
    T_mix = T_send * (1 + mu * g_mix)
    T     = max(T_bw, T_mix) + tail * (1 + nu * g_mix)

i.e. the epoch is bandwidth-limited by its most contended link under
max-min fair sharing with competing noise flows (T_bw), but never beats
the serialization + congested-pipe time of the host->leader stream
(T_mix); the latency tail (leaf timeout windows, leader aggregation, hops)
rides on top and crosses the same congested links.

The lowering replicates the *exact* placement the packet engine would use
(``run_allreduce``'s per-rep RNG: participants via ``rng.sample``, noise =
complement), so per-rep variation in the flow backend comes from the same
source as in the packet engine: where the hosts landed. What it does NOT
replicate is within-run randomness (flowlet hashes, adaptive LB draws,
static-root draws from the simulator RNG) — that is the documented,
calibrated-over divergence (ARCHITECTURE.md §Backends).

Everything here is pure Python (no jax, no numpy): lowering must be
importable wherever ``repro.core.canary`` is.
"""
from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ..canary.types import SimConfig

from .calibrate import FamilyParams, params_for


@dataclass
class FlowCell:
    """One lowered experiment cell (plain floats/lists: jax-free)."""

    label: str
    rep: int
    # modeled links: parallel lists, one entry per link class instance
    link_load_bytes: List[float] = field(default_factory=list)
    link_noise_frac: List[float] = field(default_factory=list)
    link_names: List[str] = field(default_factory=list)   # diagnostics only
    # scalar pipe/tail terms
    t_send_ns: float = 0.0
    tail_ns: float = 0.0
    g_mix: float = 0.0
    bytes_per_ns: float = 12.5
    data_bits: float = 0.0
    # per-cell calibration scalars (resolved at lowering from the family)
    kappa: float = 1.0
    floor: float = 0.08
    mu: float = 2.0
    nu: float = 1.0

    def add_link(self, name: str, load_bytes: float, noise_frac: float):
        self.link_names.append(name)
        self.link_load_bytes.append(load_bytes)
        self.link_noise_frac.append(noise_frac)


def expected_distinct(n_draws: int, n_slots: int) -> float:
    """E[#distinct] of ``n_draws`` uniform draws over ``n_slots`` (static
    tree roots / designated switches are drawn with replacement)."""
    if n_slots <= 0:
        return 1.0
    return n_slots * (1.0 - (1.0 - 1.0 / n_slots) ** n_draws)


def _placement(cfg: SimConfig, item: dict) -> Tuple[List[int], List[int]]:
    """Replicate run_allreduce's per-rep host split exactly."""
    rng = random.Random(cfg.seed * 1000003 + item["rep"])
    chosen = rng.sample(range(cfg.num_hosts), item["num_hosts"])
    if item.get("congestion"):
        chosen_set = set(chosen)
        noise = [h for h in range(cfg.num_hosts) if h not in chosen_set]
    else:
        noise = []
    return chosen, noise


def _per_leaf_counts(cfg: SimConfig, hosts: List[int]) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    for h in hosts:
        leaf = h // cfg.hosts_per_leaf
        counts[leaf] = counts.get(leaf, 0) + 1
    return counts


def _noise_split(q_leaf: int, q_total: int) -> float:
    """Fraction of one noise host's (line-rate) traffic that leaves its
    leaf: destinations are uniform over the *other* noise hosts."""
    if q_total <= 1:
        return 0.0
    return (q_total - q_leaf) / (q_total - 1)


def lower_item(item: dict) -> FlowCell:
    """Lower one sweep work item into a :class:`FlowCell`."""
    cfg = SimConfig(**item["cfg"])
    if cfg.transport != "none":
        # the flow model has no packets, queues or timers — silently ignoring
        # a transport policy would report fidelity it doesn't have
        raise ValueError(
            f"the flow backend cannot model transport={cfg.transport!r}; "
            "use backend='packet' for transport-policy experiments")
    if cfg.telemetry:
        # no packets, descriptors or probe events exist here — there is
        # nothing for the telemetry hub to observe
        raise ValueError(
            "the flow backend cannot record telemetry; "
            "use backend='packet' for telemetry runs")
    if cfg.faults:
        # no event stream exists to inject EV_FAULT/EV_HEAL into, and the
        # closed-form solver has no notion of a mid-run topology change —
        # silently dropping the schedule would fake survivability results
        raise ValueError(
            "the flow backend cannot model fault injection; "
            "use backend='packet' for fault-schedule experiments")
    if "lb" in item:
        cfg = dataclasses.replace(cfg, lb=item["lb"])
    algo = item["algo"]
    n_trees = int(item.get("n_trees", 1))
    chosen, noise = _placement(cfg, item)
    p = len(chosen)
    blocks = max(1, -(-item["data_bytes"] // cfg.payload_bytes))
    mtu = cfg.mtu_bytes
    wire = float(blocks * mtu)              # framed bytes of one full pass
    c_bps = cfg.bytes_per_ns
    fam = params_for(cfg.topology, algo)

    cell = FlowCell(label=item["label"], rep=item["rep"],
                    bytes_per_ns=c_bps,
                    data_bits=float(item["data_bytes"] * 8),
                    kappa=fam.kappa, floor=fam.floor, nu=fam.nu)

    p_leaf = _per_leaf_counts(cfg, chosen)
    q_leaf = _per_leaf_counts(cfg, noise)
    q_total = len(noise)

    if algo == "ring":
        _lower_ring(cell, cfg, fam, item, p, q_leaf, q_total)
        return cell

    # ---- serialization pipe: every host streams all B blocks once --------
    cell.t_send_ns = wire / c_bps
    cell.add_link("host_up_nic", wire, 0.0)          # participant NICs are
    cell.add_link("host_down_nic", wire, 0.0)        # private: no noise share

    if cfg.topology == "three_tier":
        g_mix = _lower_three_tier(cell, cfg, fam, algo, n_trees, wire,
                                  p, p_leaf, q_leaf, q_total)
        # cross-pod path: host-leaf-agg-core-agg-leaf-leader and back
        hops, timeout_levels = 12, 3    # descriptors at leaf+agg+core all
    else:                               # ride out the aggregation window
        g_mix = _lower_fat_tree(cell, cfg, fam, algo, n_trees, wire,
                                p, p_leaf, q_leaf, q_total)
        hops, timeout_levels = 5, 1     # leaf/spine windows overlap

    cell.g_mix = g_mix
    # mu resolved per family; static trees feel root concentration in the
    # pipe before the hard per-link bound does (mu_ntree / E[distinct])
    cell.mu = fam.mu
    if algo == "static_tree":
        slots = cfg.num_spines if cfg.topology == "fat_tree" else \
            max(1, cfg.aggs_per_pod)
        cell.mu += fam.mu_ntree / expected_distinct(n_trees, slots)

    # ---- latency tail ----------------------------------------------------
    if algo == "canary":
        # switch descriptors always ride out the aggregation window (their
        # `hosts` field counts global participants, not local fan-in), the
        # leader adds its per-block processing, and the leader's broadcast
        # of its own B/p blocks drains behind the tail of its send stream.
        own = blocks / max(1, p)
        cell.tail_ns = (timeout_levels * cfg.timeout_ns
                        + cfg.leader_aggregate_ns
                        + hops * cfg.hop_latency_ns
                        + 2.0 * own * mtu / c_bps)
    else:
        # static trees flush on exact expected counts: hops only (the
        # broadcast pipeline hides most of the return path)
        cell.tail_ns = (hops - 4 if cfg.topology == "three_tier" else hops) \
            * cfg.hop_latency_ns
    return cell


# --------------------------------------------------------------------- fat
def _lower_fat_tree(cell: FlowCell, cfg: SimConfig, fam: FamilyParams,
                    algo: str, n_trees: int, wire: float, p: int,
                    p_leaf: Dict[int, int], q_leaf: Dict[int, int],
                    q_total: int) -> float:
    """Model the 2-level leaf/spine fabric; returns g_mix."""
    spines = max(1, cfg.num_spines)
    # how many distinct leaf->spine links the foreground spreads over:
    # CANARY hashes blocks over every spine; N static trees concentrate on
    # E[distinct roots] designated spine links per leaf.
    if algo == "canary":
        spread = float(spines)
    else:
        spread = expected_distinct(n_trees, spines)

    g_sum, g_w = 0.0, 0.0
    for leaf, np_ in p_leaf.items():
        q = q_leaf.get(leaf, 0)
        # noise demand crossing this leaf's up/down fabric links, as a
        # fraction of one link's capacity (spread over all spine links)
        g_fab = q * _noise_split(q, q_total) / spines
        infl = 1.0 + fam.sigma * min(1.0, g_fab) if algo == "canary" else 1.0
        _fabric_links(cell, f"leaf{leaf}", wire * infl, spread,
                      float(spines), g_fab, fam.pool)
        g_sum += np_ * min(1.0, g_fab)
        g_w += np_
    return (g_sum / g_w) if g_w else 0.0


# Mean noise share beyond which a link tier behaves as saturated: flowlet
# noise arrives in line-rate bursts, so instantaneous overload (and with it
# unbounded FIFO backlog) sets in well before the time-average hits 1.0.
# The packet engine shows N static trees already flat in N at g ~ 0.93 on
# the oversubscribed folded Clos.
SATURATION_POOL_G = 0.85


def _fabric_links(cell: FlowCell, name: str, fg_bytes: float, spread: float,
                  n_links: float, g: float, pool: float = 1.0) -> None:
    """Emit the up/down fabric-link pair for one leaf (or pod).

    Unsaturated: the foreground concentrates on its ``spread`` designated
    links while noise spreads over all of them — the designated link is the
    bottleneck. Saturated (``g >= SATURATION_POOL_G``): FIFO backlog grows
    on every link of the tier and service equalizes, so concentrating vs
    spreading the foreground loses most of its meaning. How much of it
    survives is scale-dependent (short epochs ride the noise backlog
    transient — fully flat in N; epochs long enough to reach the fair-share
    steady state keep part of the 1/spread benefit), so the saturated
    per-link load blends the two regimes with the fitted ``pool``:
    ``fg * (pool/n_links + (1-pool)/spread)``. ``pool=1`` is fully pooled
    (N static trees flat on the oversubscribed folded Clos at FAST scale);
    smaller values restore part of the designated-link spreading."""
    if g >= SATURATION_POOL_G:
        eff = fg_bytes * (pool / n_links + (1.0 - pool) / spread)
        cell.add_link(f"{name}_up", eff, g)
        cell.add_link(f"{name}_down", eff, g)
    else:
        cell.add_link(f"{name}_up", fg_bytes / spread, g)
        cell.add_link(f"{name}_down", fg_bytes / spread, g)


# ------------------------------------------------------------------- 3tier
def _lower_three_tier(cell: FlowCell, cfg: SimConfig, fam: FamilyParams,
                      algo: str, n_trees: int, wire: float, p: int,
                      p_leaf: Dict[int, int], q_leaf: Dict[int, int],
                      q_total: int) -> float:
    """Model the folded-Clos fabric (leaf/agg/core); returns g_mix.

    The structural difference from the fat tree: leaves are oversubscribed
    (``aggs_per_pod`` up-links for ``hosts_per_leaf`` hosts), so noise can
    exceed leaf uplink capacity — the noise carried into the agg/core tier
    is capped by what the leaf uplinks actually admit (a one-step max-min
    waterfall), and static trees funnel each pod through a single
    designated agg (§3.1: the tree is static), which is the link the packet
    engine shows saturating.
    """
    aggs = max(1, cfg.aggs_per_pod)
    cores = max(1, cfg.num_cores)
    leaves_per_pod = max(1, cfg.num_leaves // max(1, cfg.num_pods))

    def pod_of(leaf: int) -> int:
        return leaf // leaves_per_pod

    p_pod: Dict[int, int] = {}
    for leaf, np_ in p_leaf.items():
        p_pod[pod_of(leaf)] = p_pod.get(pod_of(leaf), 0) + np_
    q_pod: Dict[int, int] = {}
    for leaf, nq in q_leaf.items():
        q_pod[pod_of(leaf)] = q_pod.get(pod_of(leaf), 0) + nq

    if algo == "canary":
        leaf_spread = float(aggs)
        agg_spread = float(aggs * cores)
    else:
        # one designated agg per (tree, pod); one core root per tree
        leaf_spread = expected_distinct(n_trees, aggs)
        agg_spread = expected_distinct(n_trees, aggs * cores)

    # noise admitted into the fabric by each leaf (capacity-capped)
    admitted_up: Dict[int, float] = {}
    g_sum, g_w = 0.0, 0.0
    for leaf in set(list(p_leaf) + list(q_leaf)):
        q = q_leaf.get(leaf, 0)
        demand = q * _noise_split(q, q_total)          # in link-capacities
        admitted_up[leaf] = min(demand, float(aggs))
        g_fab = demand / aggs
        np_ = p_leaf.get(leaf, 0)
        if np_:
            infl = (1.0 + fam.sigma * min(1.0, g_fab)
                    if algo == "canary" else 1.0)
            _fabric_links(cell, f"leaf{leaf}", wire * infl, leaf_spread,
                          float(aggs), g_fab, fam.pool)
            g_sum += np_ * min(1.0, g_fab)
            g_w += np_

    # agg<->core tier, per pod: cross-pod noise share of what the leaves
    # admitted, spread over the pod's aggs*cores uplinks
    for pod in set(pod_of(l) for l in p_leaf):
        qp = q_pod.get(pod, 0)
        cross = (q_total - qp) / max(1, q_total - 1) if q_total > 1 else 0.0
        up_frac_mean = _noise_split(1, q_total) or 1.0
        admitted = sum(a for l, a in admitted_up.items() if pod_of(l) == pod)
        noise_cross = admitted * (cross / up_frac_mean if up_frac_mean else 0)
        g_core = min(noise_cross, admitted) / (aggs * cores)
        pp = p_pod.get(pod, 0)
        # cross-pod share of the foreground: blocks led outside this pod
        share = 1.0 - (pp / max(1, p)) if algo == "canary" else 1.0
        infl = (1.0 + fam.sigma * min(1.0, g_core)
                if algo == "canary" else 1.0)
        _fabric_links(cell, f"pod{pod}_agg", wire * share * infl,
                      agg_spread, float(aggs * cores), g_core, fam.pool)
        if pp:
            g_sum += pp * min(1.0, g_core)
            g_w += pp
    return (g_sum / g_w) if g_w else 0.0


# -------------------------------------------------------------------- ring
def _lower_ring(cell: FlowCell, cfg: SimConfig, fam: FamilyParams,
                item: dict, p: int, q_leaf: Dict[int, int],
                q_total: int) -> None:
    """Host-based ring: 2(p-1) serialized chunk exchanges per host.

    Uncalibrated against the packet engine (ring is not on the fig7
    acceptance grid); structural only — bandwidth-optimal wire time plus a
    per-step latency ladder, congestion entering through the mean fabric
    noise share like every other family.
    """
    chunk = -(-item["data_bytes"] // max(1, p))
    pkts = max(1, -(-chunk // cfg.payload_bytes))
    steps = 2 * (p - 1)
    wire = float(steps * pkts * cfg.mtu_bytes)
    cell.t_send_ns = wire / cell.bytes_per_ns
    cell.add_link("host_up_nic", wire, 0.0)
    fabric = max(1, cfg.num_spines if cfg.topology == "fat_tree"
                 else cfg.aggs_per_pod)
    if q_leaf:
        g = sum(q * _noise_split(q, q_total) / fabric
                for q in q_leaf.values()) / len(q_leaf)
    else:
        g = 0.0
    cell.g_mix = g
    cell.mu = fam.mu
    # neighbours are random hosts: ~every step crosses the fabric
    hops = 3 if cfg.topology == "fat_tree" else 4
    cell.tail_ns = steps * cfg.hop_latency_ns * hops
    cell.add_link("ring_fabric", wire, g)


def solve_cell(cell: FlowCell) -> Tuple[float, float]:
    """Pure-Python reference solver (mirrors ``batch.py``'s jitted math
    exactly; used by tests and anywhere jax is unavailable). Returns
    ``(runtime_ns, goodput_gbps)``."""
    t_bw = 0.0
    for load, g in zip(cell.link_load_bytes, cell.link_noise_frac):
        avail = min(1.0, max(1.0 - cell.kappa * g, cell.floor))
        t_bw = max(t_bw, load / (cell.bytes_per_ns * avail))
    t_mix = cell.t_send_ns * (1.0 + cell.mu * cell.g_mix)
    t = max(t_bw, t_mix) + cell.tail_ns * (1.0 + cell.nu * cell.g_mix)
    return t, cell.data_bits / t if t > 0 else 0.0
