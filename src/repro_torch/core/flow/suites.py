"""The sweep grids the flow backend and its validation run over: the port's
own copy of the reference benchmarks' suite expansion
(``benchmarks/sweep.py``'s ``expand_suite``, ``benchmarks/common.py``'s
``bench_cfg`` / ``bench_size``), so that the flow package needs nothing
outside ``repro_torch``.

The scale follows the same environment knobs: ``BENCH_PAPER_SCALE=1`` is
the paper's 1024-host network and 4 MiB, ``BENCH_FAST=1`` a 16-host fat
tree and 128 KiB, neither the default 64 hosts and 1 MiB. A ``topology``
named in ``PAPER_SCALES`` (``fat_tree_1024`` ... ``three_tier_4096``)
selects that fabric whatever the knobs say.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List

from ..canary.types import (PAPER_SCALES, SimConfig, paper_config,
                            paper_scale_config, scaled_config,
                            three_tier_config)

SUITES = ("fig7", "fig8", "lb")


def _knob(name: str) -> bool:
    return bool(int(os.environ.get(name, "0")))


def bench_cfg(**overrides) -> SimConfig:
    if _knob("BENCH_PAPER_SCALE"):
        return paper_config(**overrides)
    if _knob("BENCH_FAST"):
        return scaled_config(4, **overrides)
    return scaled_config(8, **overrides)


def bench_size() -> int:
    if _knob("BENCH_PAPER_SCALE"):
        return 4 * 2 ** 20          # the paper's 4 MiB
    if _knob("BENCH_FAST"):
        return 128 * 2 ** 10
    return 2 ** 20                  # 1 MiB at 1/16 scale


def _base_cfg(topology: str) -> SimConfig:
    if topology in PAPER_SCALES:
        return paper_scale_config(topology)
    if topology == "three_tier":
        return three_tier_config(num_pods=4, leaves_per_pod=2,
                                 hosts_per_leaf=8, aggs_per_pod=2, num_cores=4)
    if topology != "fat_tree":
        raise ValueError(f"unknown topology {topology!r} (have: fat_tree, "
                         f"three_tier, {', '.join(sorted(PAPER_SCALES))})")
    return bench_cfg()


def expand_suite(suite: str, topology: str, reps: int) -> List[dict]:
    """Expand a named sweep into independent work-item dicts."""
    cfg = _base_cfg(topology)
    n = max(2, int(cfg.num_hosts * 0.5))  # 50% participants
    size = bench_size()
    items: List[dict] = []
    if suite == "fig7":
        # static 1/2/4/8 trees vs canary, with and without congestion
        cells = [("static1", "static_tree", 1), ("static2", "static_tree", 2),
                 ("static4", "static_tree", 4), ("static8", "static_tree", 8),
                 ("canary", "canary", 1)]
        for cong in (False, True):
            for label, algo, nt in cells:
                for rep in range(reps):
                    items.append(dict(label=f"{label}/cong={int(cong)}",
                                      algo=algo, n_trees=nt, congestion=cong,
                                      num_hosts=n, data_bytes=size, rep=rep))
    elif suite == "fig8":
        # goodput vs fraction of hosts running the allreduce, the rest
        # generating congestion
        for frac in (0.05, 0.25, 0.5, 0.75):
            nf = max(2, int(cfg.num_hosts * frac))
            for algo in ("static_tree", "canary"):
                for rep in range(reps):
                    items.append(dict(label=f"{algo}/hosts={int(frac * 100)}%",
                                      algo=algo, n_trees=1, congestion=True,
                                      num_hosts=nf, data_bytes=size, rep=rep))
    elif suite == "lb":
        # load-balancing policy sensitivity under congestion
        for lb in ("ecmp", "adaptive", "per_packet"):
            for rep in range(reps):
                items.append(dict(label=f"canary/lb={lb}", algo="canary",
                                  n_trees=1, congestion=True, lb=lb,
                                  num_hosts=n, data_bytes=size, rep=rep))
    else:
        raise ValueError(f"unknown sweep suite {suite!r} (have: "
                         f"{', '.join(SUITES)})")
    for it in items:
        it["topology"] = topology
        it["cfg"] = dataclasses.asdict(cfg)
    return items
