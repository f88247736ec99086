"""Workload compiler: model configs -> bucketed gradient traffic -> predicted
iteration time.

The missing bridge between the repo's ML stack (``repro.models`` /
``repro.configs`` — ten published architectures) and the packet-level
simulator, letting the repo answer "how much faster does this *model* train
under Canary?" rather than "how fast is one 1 MiB allreduce?":

* :mod:`~.model_comm` — per-layer gradient sizes from any registered
  :class:`~repro.models.config.ModelConfig`, packed into DDP-style
  reverse-layer-order buckets (dtype-aware, MoE-expert-sharding-aware).
* :mod:`~.timeline`   — the backward pass as roofline-estimated compute
  segments that release buckets over time.
* :mod:`~.predictor`  — each bucket becomes an ``AllreduceJob`` with a
  staggered ``arrival_ns`` (the fleet subsystem's ``EV_JOB_ARRIVE`` path);
  one simulator run yields predicted iteration time and the
  exposed-communication fraction, with scaling curves over hosts x
  algorithm x congestion.
* :mod:`~.scenarios`  — named ready-made scenarios (dense llama3 /
  deepseek-moe / mamba2 / whisper on fat_tree / three_tier).

Pure analysis + simulator consumers: importing this package touches neither
jax nor any simulator state (goldens replay bit-for-bit with it imported —
pinned by ``tests/workload/test_workload_fleet.py``).
"""
from .model_comm import (GRAD_DTYPE_BYTES, CommPlan, GradBucket, GradSegment,
                         grad_dtype_bytes, grad_segments, pack_buckets,
                         total_dp_grad_bytes)
from .predictor import (BucketOutcome, IterationPrediction, compile_jobs,
                        pick_participants, predict_iteration, scaling_curves)
from .scenarios import (SCENARIOS, WorkloadScenario, get_model_config,
                        get_scenario, list_scenarios, make_sim_cfg,
                        predict_scenario, register_scenario)
from .timeline import (ComputeSegment, HostSpec, IterationTimeline,
                       build_timeline)

__all__ = [
    "GRAD_DTYPE_BYTES", "SCENARIOS", "BucketOutcome", "CommPlan",
    "ComputeSegment", "GradBucket", "GradSegment", "HostSpec",
    "IterationPrediction", "IterationTimeline", "WorkloadScenario",
    "build_timeline", "compile_jobs", "get_model_config", "get_scenario",
    "grad_dtype_bytes",
    "grad_segments", "list_scenarios", "make_sim_cfg", "pack_buckets",
    "pick_participants", "predict_iteration", "predict_scenario",
    "register_scenario", "scaling_curves", "total_dp_grad_bytes",
]
