"""Calibration constants pinning the flow model to the packet engine.

The flow model (``model.py``) has free constants that packet-level effects
determine but a fluid model cannot derive from first principles — how much
worse than the time-average a FIFO link treats a foreground flow when
flowlet-routed noise arrives in bursts (``kappa``), how strongly congestion
stretches the host->leader pipe (``mu``) and the latency tail (``nu``), and
how many extra timeout-flush partials a congested CANARY epoch emits
(``sigma``, the §3.2 per-round tree-reshaping term). They are fitted, per
(topology family, algorithm family), against pinned packet-engine reference
sweeps — the fig7 grid at FAST (scale-4 / 128 KiB) and default bench
(scale-8 / 1 MiB) scale on both fabrics — by ``scripts/fit_flow_model.py``,
and the result is pinned here. Refitting is a deliberate act (run the
script, review the per-cell residuals it prints, commit the new table);
nothing refits at import or run time.

``validate.py`` is the enforcement side: it replays flow vs packet on the
pinned grid and fails beyond the documented tolerance, so a drift in either
the engine or the model surfaces as a test failure, not silent skew.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FamilyParams:
    """Fitted constants for one (topology, algorithm-family) pair.

    * ``kappa``  — noise amplification on shared links: a link with raw
      time-average noise demand fraction ``g`` serves foreground traffic at
      ``C * max(1 - kappa*g, floor)``. ``kappa > 1`` captures burstiness
      (flowlet noise overshoots its mean on the link it currently rides),
      ``kappa < 1`` captures congestion-aware load balancing steering the
      foreground around hot links.
    * ``floor``  — minimum service share on a saturated link (FIFO never
      starves a flow completely; packets already queued do drain).
    * ``mu``     — pipe-stretch: congestion multiplies the serialization
      time ``T_send`` by ``(1 + mu * g_mix)``.
    * ``mu_ntree`` — extra pipe-stretch ``mu_ntree / E[distinct roots]``
      for static trees: fewer trees concentrate load on fewer designated
      links, which the mixing term feels before the hard bandwidth bound.
    * ``nu``     — tail-stretch: the latency tail (timeouts, leader
      aggregation, hops) crosses the same congested links, so it stretches
      by ``(1 + nu * g_mix)``.
    * ``sigma``  — CANARY timeout-flush inflation: congested epochs emit
      ``(1 + sigma * g_mix)`` partial aggregates per block instead of 1
      (stragglers split the aggregation tree per round).
    * ``pool``   — saturated-tier pooling blend in [0, 1]: 1 means a
      saturated tier fully equalizes (spreading the foreground over more
      trees buys nothing — the FAST-scale behaviour), smaller values keep
      part of the designated-link 1/spread benefit (longer epochs reach
      the fair-share steady state). See ``model._fabric_links``.
    """

    kappa: float = 1.0
    floor: float = 0.08
    mu: float = 2.0
    mu_ntree: float = 0.0
    nu: float = 1.0
    sigma: float = 0.0
    pool: float = 1.0


# Pinned by scripts/fit_flow_model.py against the packet-engine reference
# grids (see module docstring). Keyed by (topology, algo family); "ring" is
# carried with structural defaults only — it is not part of the fig7
# acceptance grid and is documented as uncalibrated in ARCHITECTURE.md.
CALIBRATION = {
    ("fat_tree", "canary"): FamilyParams(
        kappa=0.6, floor=0.04, mu=1.8, mu_ntree=0.0, nu=1.0, sigma=0.0,
        pool=1.0),
    ("fat_tree", "static_tree"): FamilyParams(
        kappa=0.9, floor=0.04, mu=2.4, mu_ntree=0.8, nu=1.0, sigma=0.0,
        pool=1.0),
    ("fat_tree", "ring"): FamilyParams(),
    ("three_tier", "canary"): FamilyParams(
        kappa=0.6, floor=0.05, mu=1.0, mu_ntree=0.0, nu=2.0, sigma=0.5,
        pool=1.0),
    ("three_tier", "static_tree"): FamilyParams(
        kappa=0.9, floor=0.08, mu=1.4, mu_ntree=0.0, nu=1.0, sigma=0.0,
        pool=0.85),
    ("three_tier", "ring"): FamilyParams(),
}


def params_for(topology: str, algo: str) -> FamilyParams:
    """Look up fitted constants; unknown fabrics fall back to the fat-tree
    row of the same family (documented: plug-in topologies start
    uncalibrated)."""
    key = (topology, algo)
    if key in CALIBRATION:
        return CALIBRATION[key]
    fallback = ("fat_tree", algo)
    if fallback in CALIBRATION:
        return CALIBRATION[fallback]
    return FamilyParams()
