"""High-level experiment drivers around the simulator.

These functions set up the host partitions the paper uses (§5.2): a fraction
of hosts runs the allreduce(s), the rest generate random-uniform congestion
traffic, with randomized placement across repetitions.
"""
from __future__ import annotations

import dataclasses
import random
import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .simulator import Simulator
from .types import Algo, AllreduceJob, SimConfig, SimResult


@dataclass
class ExperimentResult:
    """Aggregated over repetitions."""

    algo: str
    n_trees: int
    goodput_gbps_mean: float
    goodput_gbps_min: float
    goodput_gbps_max: float
    runtime_us_mean: float
    avg_utilization: float
    link_utilization: List[float]
    correct: bool
    reps: List[SimResult]

    def row(self) -> str:
        return (f"{self.algo}(t={self.n_trees}) goodput={self.goodput_gbps_mean:.1f}Gbps "
                f"runtime={self.runtime_us_mean:.1f}us util={self.avg_utilization:.3f} "
                f"correct={self.correct}")


def pick_hosts(cfg: SimConfig, n: int, rng: random.Random) -> List[int]:
    return rng.sample(range(cfg.num_hosts), n)


def build_cell_simulator(cfg: SimConfig, algo: Algo,
                         num_allreduce_hosts: int, data_bytes: int, *,
                         n_trees: int = 1, congestion: bool = False,
                         num_apps: int = 1, rep: int = 0) -> Simulator:
    """Construct rep ``rep`` of one experiment cell — the exact Simulator
    :func:`run_allreduce` would run, handed back unstarted so callers can
    keep the live object (the telemetry exporters need the hub after
    ``run()``, which ``ExperimentResult`` does not carry)."""
    rng = random.Random(cfg.seed * 1000003 + rep)
    chosen = pick_hosts(cfg, num_allreduce_hosts, rng)
    per_app = max(2, num_allreduce_hosts // num_apps)
    jobs = []
    for a in range(num_apps):
        parts = chosen[a * per_app:(a + 1) * per_app]
        if len(parts) < 2:
            break
        jobs.append(AllreduceJob(app=a, participants=parts,
                                 data_bytes=data_bytes))
    noise = [h for h in range(cfg.num_hosts) if h not in set(chosen)] \
        if congestion else []
    rcfg = dataclasses.replace(cfg, seed=cfg.seed + rep)
    return Simulator(rcfg, jobs, algo=algo, n_trees=n_trees,
                     noise_hosts=noise)


def run_allreduce(cfg: SimConfig,
                  algo: Algo,
                  num_allreduce_hosts: int,
                  data_bytes: int,
                  *,
                  n_trees: int = 1,
                  congestion: bool = False,
                  num_apps: int = 1,
                  reps: int = 1,
                  rep0: int = 0,
                  partition_hosts: bool = True) -> ExperimentResult:
    """Run ``num_apps`` concurrent allreduces over ``num_allreduce_hosts`` total
    hosts (equally partitioned), optionally with all remaining hosts generating
    random-uniform congestion traffic (§5.2).

    ``rep0`` offsets the repetition index: ``reps=1, rep0=r`` reproduces rep
    ``r`` of a ``reps=r+1`` call exactly, which is how the parallel sweep
    runner (``benchmarks/sweep.py``) splits an experiment into independent
    per-rep work items without changing its results."""
    results: List[SimResult] = []
    for rep in range(rep0, rep0 + reps):
        sim = build_cell_simulator(cfg, algo, num_allreduce_hosts, data_bytes,
                                   n_trees=n_trees, congestion=congestion,
                                   num_apps=num_apps, rep=rep)
        results.append(sim.run())
    gp = [statistics.mean(r.goodput_gbps.values()) for r in results]
    rt = [r.duration_ns / 1e3 for r in results]
    return ExperimentResult(
        algo=str(algo),
        n_trees=n_trees,
        goodput_gbps_mean=statistics.mean(gp),
        goodput_gbps_min=min(gp),
        goodput_gbps_max=max(gp),
        runtime_us_mean=statistics.mean(rt),
        avg_utilization=statistics.mean(r.avg_utilization for r in results),
        link_utilization=results[-1].link_utilization,
        correct=all(r.correct for r in results),
        reps=results,
    )


def compare_algorithms(cfg: SimConfig, num_allreduce_hosts: int,
                       data_bytes: int, *, congestion: bool,
                       static_trees: Sequence[int] = (1, 4),
                       reps: int = 1) -> Dict[str, ExperimentResult]:
    """The paper's core comparison: ring vs N static trees vs Canary."""
    out: Dict[str, ExperimentResult] = {}
    out["ring"] = run_allreduce(cfg, Algo.RING, num_allreduce_hosts, data_bytes,
                                congestion=congestion, reps=reps)
    for n in static_trees:
        out[f"static_{n}"] = run_allreduce(cfg, Algo.STATIC_TREE,
                                           num_allreduce_hosts, data_bytes,
                                           n_trees=n, congestion=congestion,
                                           reps=reps)
    out["canary"] = run_allreduce(cfg, Algo.CANARY, num_allreduce_hosts,
                                  data_bytes, congestion=congestion, reps=reps)
    return out
