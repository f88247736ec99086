"""Flow-vs-packet validation harness: the divergence contract, enforced.

The flow backend is useful exactly to the extent its predictions track the
packet engine, so the tolerance is not a comment — it is executable. This
module pins a validation grid (the fig7 suite: CANARY vs 1/2/4/8 static
trees, with and without congestion, on both fabrics), runs every cell
through BOTH backends interleaved (flow lowering next to the packet run it
is checked against, so a drift in either surfaces at the same commit), and
fails if any per-label mean runtime or goodput diverges beyond the
documented tolerance.

Tolerances (documented in ARCHITECTURE.md §Backends):

* ``MID_TOLERANCE = 0.15`` — the acceptance contract, at the default bench
  scale (64 hosts, 1 MiB): per-label rep-mean runtime and goodput within
  ±15% of the packet engine on every fig7 cell of both topologies.
* ``FAST_TOLERANCE = 0.60`` — the CI smoke bound, at BENCH_FAST scale
  (16/32 hosts, 128 KiB): congested cells at scale-4 are dominated by
  placement luck (two reps of the *packet engine itself* differ by up to
  ~70% there), so the smoke grid only guards against gross model breakage;
  the ±15% claim is made — and checked — at mid scale.

A label whose *packet* reps spread further apart than the tolerance itself
(``max/min - 1 > tolerance``) is reported but exempt from the gate: when the
reference disagrees with itself by more than the allowed error, its 2-rep
mean is noise, not a standard (at FAST scale, fat-tree static4/cong=1 is
exactly this cell — packet reps 30.9us vs 53.6us). The exemption is
tolerance-scaled, so tightening the bound never silently widens it, and
every exempt label carries ``reference_unstable: true`` in the report.

Usage::

    PYTHONPATH=src python -m repro_torch.core.flow.validate      # mid scale
    BENCH_FAST=1 PYTHONPATH=src python -m repro_torch.core.flow.validate
    # the flow solve runs on the card; on a machine without one:
    ... validate --device cpu
    # reuse a recorded packet sweep for the expensive side:
    ... validate --packet-ref three_tier=sweep_fig7_three_tier.json

The run writes ``flow_validation.json`` (``--out`` to move it) with every
per-cell pair, so the divergence trajectory is a recorded artifact.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict, List

MID_TOLERANCE = 0.15
FAST_TOLERANCE = 0.60
REPS = 2          # pinned: the grid compares per-label means over 2 reps

# The three-tier mid grid is pinned at 512 KiB, not the fat-tree's 1 MiB:
# at 1 MiB the congested three-tier cells blow the packet engine's OWN
# livelock valve (SimConfig.max_events = 200M — the event count goes over a
# cliff between 512 KiB and 1 MiB as timeout-flush cascades compound), so
# 512 KiB is the largest size at which a packet reference for this fabric
# exists at all. A reference the reference engine cannot produce cannot
# anchor a tolerance.
THREE_TIER_MID_BYTES = 512 * 1024


def validation_items(topology: str, fast: bool) -> List[dict]:
    """The pinned grid: fig7 on one fabric at the bench scale implied by
    the BENCH_* env (``suites.expand_suite`` reads it), except the
    three-tier mid grid's message size (see THREE_TIER_MID_BYTES)."""
    from .suites import expand_suite
    items = expand_suite("fig7", topology, REPS)
    if topology == "three_tier" and not fast:
        for it in items:
            it["data_bytes"] = THREE_TIER_MID_BYTES
    return items


def _label_means(cells: List[dict]) -> Dict[str, Dict[str, float]]:
    by: Dict[str, List[dict]] = {}
    for c in cells:
        by.setdefault(c["label"], []).append(c)
    return {label: dict(
        runtime_us=statistics.mean(c["runtime_us"] for c in cs),
        goodput_gbps=statistics.mean(c["goodput_gbps"] for c in cs))
        for label, cs in by.items()}


def run_validation(topologies=("fat_tree", "three_tier"),
                   tolerance: float = None, fast: bool = None,
                   packet_refs: Dict[str, dict] = None,
                   device=None) -> dict:
    """Run the pinned grid through both backends; returns the report dict
    (``ok``, per-cell pairs, per-label divergences). Raises nothing —
    callers check ``report["ok"]``.

    ``packet_refs`` maps a topology to a *recorded* packet-backend sweep
    document (``benchmarks/sweep.py`` JSON) to use in place of live packet
    runs — the way to validate against an expensive reference (the 3-tier
    mid grid costs packet-engine hours) without re-simulating it. The doc
    must be a packet run of the same suite/topology/reps; every grid cell
    must be present in it. ``device`` is where the flow backend solves
    (``None``: the card)."""
    import os

    from ..canary import get_backend
    from .backend import FlowBackend
    if fast is None:
        fast = bool(int(os.environ.get("BENCH_FAST", "0")))
    if tolerance is None:
        tolerance = FAST_TOLERANCE if fast else MID_TOLERANCE
    packet_refs = packet_refs or {}
    packet = get_backend("packet")
    flow = FlowBackend(device)
    grids = []
    worst = 0.0
    ok = True
    for topo in topologies:
        items = validation_items(topo, fast)
        ref = packet_refs.get(topo)
        if ref is not None:
            if ref.get("backend", "packet") != "packet" or \
                    ref.get("topology") != topo or \
                    ref.get("suite") != "fig7" or ref.get("reps") != REPS:
                raise ValueError(
                    f"packet ref for {topo!r} is not a packet fig7/"
                    f"reps={REPS} sweep of that topology")
            recorded = {(c["label"], c["rep"]): c for c in ref["results"]}
        # interleaved: each packet cell immediately followed by its flow
        # counterpart, so both see the identical work item
        pairs = []
        flow_cells = flow.run_cells(items)      # one batched call
        for item, fc in zip(items, flow_cells):
            if ref is not None:
                pc = recorded[(item["label"], item["rep"])]
            else:
                pc = packet.run_cell(item)
            pairs.append(dict(label=item["label"], rep=item["rep"],
                              packet_runtime_us=pc["runtime_us"],
                              flow_runtime_us=fc["runtime_us"],
                              packet_goodput=pc["goodput_gbps"],
                              flow_goodput=fc["goodput_gbps"]))
        p_means = _label_means([dict(label=p["label"],
                                     runtime_us=p["packet_runtime_us"],
                                     goodput_gbps=p["packet_goodput"])
                                for p in pairs])
        f_means = _label_means([dict(label=p["label"],
                                     runtime_us=p["flow_runtime_us"],
                                     goodput_gbps=p["flow_goodput"])
                                for p in pairs])
        p_reps: Dict[str, List[float]] = {}
        for p in pairs:
            p_reps.setdefault(p["label"], []).append(p["packet_runtime_us"])
        labels = {}
        for label in p_means:
            rt_err = (f_means[label]["runtime_us"]
                      - p_means[label]["runtime_us"]) \
                / p_means[label]["runtime_us"]
            gp_err = (f_means[label]["goodput_gbps"]
                      - p_means[label]["goodput_gbps"]) \
                / p_means[label]["goodput_gbps"]
            err = max(abs(rt_err), abs(gp_err))
            spread = max(p_reps[label]) / min(p_reps[label]) - 1.0
            unstable = spread > tolerance
            within = err <= tolerance or unstable
            if not unstable:
                worst = max(worst, err)
            ok &= within
            labels[label] = dict(
                packet_runtime_us=p_means[label]["runtime_us"],
                flow_runtime_us=f_means[label]["runtime_us"],
                runtime_err=rt_err, goodput_err=gp_err,
                packet_rep_spread=spread, reference_unstable=unstable,
                within=within)
        grids.append(dict(topology=topo, labels=labels, pairs=pairs))
    return dict(ok=ok, tolerance=tolerance, fast=fast, worst_err=worst,
                grids=grids)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--topology", action="append", default=None,
                    help="repeatable; default: fat_tree + three_tier")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="override the scale-implied tolerance")
    ap.add_argument("--packet-ref", action="append", default=[],
                    metavar="TOPOLOGY=SWEEP.json",
                    help="use a recorded packet sweep document for this "
                         "topology instead of running the packet engine")
    ap.add_argument("--out", default="flow_validation.json")
    ap.add_argument("--device", default=None,
                    help="where the flow backend solves (default: the card)")
    args = ap.parse_args(argv)
    topos = tuple(args.topology) if args.topology else \
        ("fat_tree", "three_tier")
    refs = {}
    for spec in args.packet_ref:
        topo, _, path = spec.partition("=")
        with open(path) as fh:
            refs[topo] = json.load(fh)
    report = run_validation(topologies=topos, tolerance=args.tolerance,
                            packet_refs=refs, device=args.device)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1, sort_keys=True)
        fh.write("\n")
    for grid in report["grids"]:
        print(f"== {grid['topology']}")
        for label, row in sorted(grid["labels"].items()):
            mark = "ok  " if row["within"] else "FAIL"
            if row["reference_unstable"]:
                mark = "ref?"
            print(f"  [{mark}] {label:20s} packet={row['packet_runtime_us']:9.1f}us "
                  f"flow={row['flow_runtime_us']:9.1f}us "
                  f"rt_err={row['runtime_err'] * 100:+6.1f}% "
                  f"gp_err={row['goodput_err'] * 100:+6.1f}%"
                  + (f"  (packet reps spread "
                     f"{row['packet_rep_spread'] * 100:.0f}% — exempt)"
                     if row["reference_unstable"] else ""))
    print(f"# worst divergence {report['worst_err'] * 100:.1f}% vs tolerance "
          f"{report['tolerance'] * 100:.0f}% "
          f"({'FAST' if report['fast'] else 'mid'} scale) -> {args.out}")
    if not report["ok"]:
        print("# VALIDATION FAILED: flow model diverges beyond the "
              "documented tolerance", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
