"""Named, ready-made training-workload scenarios.

Each scenario pins everything a prediction needs: which registered
architecture (smoke variant — the full configs work identically but are not
CPU-test material), the fabric it trains on, the data-parallel degree, batch
geometry, DDP bucket size and the wire-byte scale (see
:mod:`~.predictor` on ``bytes_scale``). The registry is string-keyed like
the simulator's algorithm/topology registries, so downstream suites and
examples name scenarios instead of re-assembling knobs:

    predict_scenario("deepseek-moe/fat_tree", algo=Algo.CANARY,
                     congestion=True)

Covered axes: dense (llama3), MoE with expert sharding (deepseek), SSM
(mamba2) and encoder-decoder audio (whisper), each on both registered
fabrics (``fat_tree`` and ``three_tier``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

# jax-free: repro.models.__init__ is lazy, so the registry imports without
# pulling the jax-backed model half (pinned by test_model_comm)
from ...models.config import ModelConfig
from ...models.registry import get_config as _registry_get_config

from ..canary.types import Algo, SimConfig, scaled_config, three_tier_config
from .predictor import IterationPrediction, predict_iteration
from .timeline import HostSpec


def get_model_config(name: str, variant: str = "smoke") -> ModelConfig:
    """``repro.models.registry.get_config`` with a smoke-variant default
    (the CPU-runnable configs are what simulator-side consumers want)."""
    return _registry_get_config(name, variant)


@dataclass(frozen=True)
class WorkloadScenario:
    """One named (model x fabric x batch geometry) training workload."""

    name: str
    arch: str                      # repro.models.registry key
    topology: str                  # "fat_tree" | "three_tier"
    dp_hosts: int = 8
    seq: int = 128
    global_batch: int = 8
    bucket_bytes: int = 1 << 17    # 128 KiB DDP buckets at smoke scale
    bytes_scale: float = 0.125     # wire-byte scale (predictor docstring)
    expert_sharding: bool = False
    variant: str = "smoke"         # "full" runs the published config
    host: HostSpec = field(default_factory=HostSpec)
    description: str = ""


SCENARIOS: Dict[str, WorkloadScenario] = {}


def register_scenario(s: WorkloadScenario) -> WorkloadScenario:
    if s.name in SCENARIOS:
        raise ValueError(f"scenario {s.name!r} already registered")
    SCENARIOS[s.name] = s
    return s


def get_scenario(name: str) -> WorkloadScenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; known: "
                       f"{sorted(SCENARIOS)}") from None


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def make_sim_cfg(scenario: WorkloadScenario, **overrides) -> SimConfig:
    """The scenario's fabric (both are ~1/16-scale models, CPU-fast)."""
    if scenario.topology == "fat_tree":
        return scaled_config(4, **overrides)            # 16 hosts
    if scenario.topology == "three_tier":
        return three_tier_config(**overrides)           # 32 hosts, 3 tiers
    raise ValueError(f"unknown topology {scenario.topology!r}")


def predict_scenario(name: str, *, algo: Algo = Algo.CANARY,
                     n_trees: int = 1, congestion: bool = False,
                     sim_cfg: Optional[SimConfig] = None,
                     **overrides) -> IterationPrediction:
    """Run one named scenario end to end. ``overrides`` replace scenario
    fields (e.g. ``dp_hosts=4, bytes_scale=0.03`` for a faster cell)."""
    s = get_scenario(name)
    if overrides:
        s = replace(s, **overrides)
    cfg = sim_cfg if sim_cfg is not None else make_sim_cfg(s)
    model = get_model_config(s.arch, s.variant)
    return predict_iteration(
        model, cfg, algo=algo, n_trees=n_trees, dp_hosts=s.dp_hosts,
        seq=s.seq, global_batch=s.global_batch, bucket_bytes=s.bucket_bytes,
        expert_sharding=s.expert_sharding, host=s.host,
        bytes_scale=s.bytes_scale, congestion=congestion)


def _register_defaults() -> None:
    models = (
        ("llama3-dense", "llama3.2-1b", False,
         "dense GQA decoder, classic DDP"),
        ("deepseek-moe", "deepseek-moe-16b", True,
         "fine-grained MoE, routed experts sharded (EP) — expert grads "
         "skip the DP allreduce"),
        ("mamba2", "mamba2-130m", False, "attention-free SSM stack"),
        ("whisper", "whisper-large-v3", False,
         "encoder-decoder audio; encoder grads release after the decoder's"),
    )
    for short, arch, ep, desc in models:
        for topo in ("fat_tree", "three_tier"):
            # the 3-tier fabric has 2x the hosts and 4-hop cross-pod paths:
            # halve the wire scale so event counts stay comparable per cell
            register_scenario(WorkloadScenario(
                name=f"{short}/{topo}", arch=arch, topology=topo,
                bytes_scale=0.125 if topo == "fat_tree" else 0.0625,
                expert_sharding=ep, description=desc))


_register_defaults()
