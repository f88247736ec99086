"""End-to-end iteration-time prediction at packet level.

Bridges the analytic side (:mod:`~.model_comm` buckets +
:mod:`~.timeline` release times) to the packet simulator: every bucket
becomes one :class:`~repro.core.canary.types.AllreduceJob` whose
``arrival_ns`` is its release time, so late buckets activate mid-run through
the fleet subsystem's ``EV_JOB_ARRIVE`` machinery while earlier buckets'
packets are still in flight — exactly DDP's compute/communication overlap.

Predicted iteration time is ``max(compute_end, last bucket finish)``: the
optimizer step is deliberately excluded (it is local and identical across
allreduce algorithms). The *exposed-communication fraction* —
``(iteration - compute) / iteration`` — is the headline number: it is the
share of the iteration the accelerators sit idle waiting for gradient
traffic, i.e. what an in-network allreduce is supposed to shrink.

``bytes_scale`` scales the simulated wire bytes. The default fabrics are
1/16-scale models of the paper's 1024-host network (see
``benchmarks/common.py``); scaling the gradient traffic by the same kind of
factor keeps smoke-model runs CPU-fast while preserving the compute/comm
overlap structure. Scale-1 full-model runs are the same code path.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ...models.config import ModelConfig

from ..canary.simulator import Simulator
from ..canary.types import Algo, AllreduceJob, SimConfig, SimResult
from .model_comm import CommPlan, pack_buckets
from .timeline import HostSpec, IterationTimeline, build_timeline


@dataclass(frozen=True)
class BucketOutcome:
    """One bucket's simulated life: released, submitted, finished."""

    index: int
    app: int
    sim_bytes: int              # wire bytes after ``bytes_scale``
    release_ns: float           # compute-side: when its gradients were ready
    finish_ns: float            # simulator: when its allreduce completed


@dataclass
class IterationPrediction:
    """Predicted end-to-end training-iteration time for one algorithm."""

    model: str
    algo: str
    plan: CommPlan
    timeline: IterationTimeline
    buckets: List[BucketOutcome]
    sim: SimResult
    iteration_ns: float
    compute_ns: float           # forward + backward (no communication)
    comm_last_finish_ns: float
    exposed_comm_ns: float      # iteration - compute: accelerator idle time
    exposed_comm_frac: float

    @property
    def correct(self) -> bool:
        return self.sim.correct

    def summary(self) -> str:
        return (f"{self.model}/{self.algo}: iter={self.iteration_ns / 1e3:.1f}us "
                f"compute={self.compute_ns / 1e3:.1f}us "
                f"exposed_comm={self.exposed_comm_frac:.1%} "
                f"buckets={len(self.buckets)} correct={self.correct}")


def pick_participants(cfg: SimConfig, n: int,
                      seed: Optional[int] = None) -> List[int]:
    """``n`` data-parallel ranks placed randomly across the fabric (same
    placement model as ``repro.core.canary.algorithms.pick_hosts``)."""
    rng = random.Random(cfg.seed if seed is None else seed)
    return rng.sample(range(cfg.num_hosts), n)


def compile_jobs(plan: CommPlan, timeline: IterationTimeline,
                 participants: Sequence[int], *, bytes_scale: float = 1.0,
                 app_base: int = 0, tenant: int = 0) -> List[AllreduceJob]:
    """Lower a (plan, timeline) pair to arrival-timed allreduce jobs."""
    if bytes_scale <= 0:
        raise ValueError("bytes_scale must be positive")
    jobs = []
    for b, release in zip(plan.buckets, timeline.bucket_release_ns):
        jobs.append(AllreduceJob(
            app=app_base + b.index, participants=list(participants),
            data_bytes=max(1, round(b.bytes * bytes_scale)),
            arrival_ns=release, tenant=tenant))
    return jobs


def predict_iteration(model_cfg: ModelConfig, sim_cfg: SimConfig, *,
                      algo: Algo = Algo.CANARY, n_trees: int = 1,
                      participants: Optional[Sequence[int]] = None,
                      dp_hosts: Optional[int] = None,
                      seq: int = 128, global_batch: int = 8,
                      bucket_bytes: int = 1 << 20,
                      grad_dtype: Optional[str] = None,
                      expert_sharding: bool = False,
                      host: Optional[HostSpec] = None,
                      bytes_scale: float = 1.0,
                      congestion: bool = False,
                      noise_hosts: Optional[Sequence[int]] = None,
                      app_base: int = 0) -> IterationPrediction:
    """Compile ``model_cfg``'s gradient traffic and simulate one iteration.

    Either pass explicit ``participants`` or a ``dp_hosts`` count (placed
    via :func:`pick_participants`). ``congestion=True`` puts every
    non-participant host on random-uniform background traffic (§5.2) unless
    ``noise_hosts`` is given explicitly.
    """
    if participants is None:
        if dp_hosts is None:
            raise ValueError("pass participants or dp_hosts")
        participants = pick_participants(sim_cfg, dp_hosts)
    participants = list(participants)
    plan = pack_buckets(model_cfg, bucket_bytes=bucket_bytes,
                        grad_dtype=grad_dtype,
                        expert_sharding=expert_sharding)
    timeline = build_timeline(model_cfg, plan, seq=seq,
                              global_batch=global_batch,
                              dp_hosts=len(participants), host=host)
    jobs = compile_jobs(plan, timeline, participants,
                        bytes_scale=bytes_scale, app_base=app_base)
    noise: List[int] = list(noise_hosts) if noise_hosts is not None else []
    if congestion and noise_hosts is None:
        pset = set(participants)
        noise = [h for h in range(sim_cfg.num_hosts) if h not in pset]
    sim = Simulator(sim_cfg, jobs, algo=algo, n_trees=n_trees,
                    noise_hosts=noise or None)
    result = sim.run()
    outcomes = [BucketOutcome(index=b.index, app=j.app, sim_bytes=j.data_bytes,
                              release_ns=j.arrival_ns,
                              finish_ns=result.job_finish_ns.get(
                                  j.app, float("nan")))
                for b, j in zip(plan.buckets, jobs)]
    compute_ns = timeline.compute_ns
    last_finish = max((o.finish_ns for o in outcomes), default=0.0)
    iteration_ns = max(compute_ns, last_finish)
    exposed = iteration_ns - compute_ns
    return IterationPrediction(
        model=model_cfg.name, algo=str(algo), plan=plan, timeline=timeline,
        buckets=outcomes, sim=result, iteration_ns=iteration_ns,
        compute_ns=compute_ns, comm_last_finish_ns=last_finish,
        exposed_comm_ns=exposed,
        exposed_comm_frac=exposed / iteration_ns if iteration_ns > 0 else 0.0)


def scaling_curves(model_cfg: ModelConfig, sim_cfg: SimConfig, *,
                   hosts_list: Sequence[int],
                   algos: Sequence[Tuple[Algo, int]] = ((Algo.CANARY, 1),
                                                        (Algo.STATIC_TREE, 1),
                                                        (Algo.RING, 1)),
                   congestion_levels: Sequence[bool] = (False, True),
                   **predict_kw) -> List[Dict]:
    """Predicted iteration time over hosts x algorithm x congestion.

    Placement is fixed per host count (all algorithms and congestion levels
    see identical participant sets), so rows are directly comparable.
    Returns one flat dict per cell, JSON-ready.
    """
    rows: List[Dict] = []
    for n in hosts_list:
        parts = pick_participants(sim_cfg, n)
        for algo, n_trees in algos:
            for cong in congestion_levels:
                p = predict_iteration(model_cfg, sim_cfg, algo=algo,
                                      n_trees=n_trees, participants=parts,
                                      congestion=cong, **predict_kw)
                rows.append({
                    "model": p.model, "hosts": n, "algo": p.algo,
                    "n_trees": n_trees, "congestion": cong,
                    "iteration_ns": p.iteration_ns,
                    "compute_ns": p.compute_ns,
                    "comm_last_finish_ns": p.comm_last_finish_ns,
                    "exposed_comm_frac": p.exposed_comm_frac,
                    "buckets": len(p.buckets),
                    "dp_grad_bytes": p.plan.total_grad_bytes,
                    "correct": p.correct,
                })
    return rows
