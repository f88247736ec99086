"""Simulation-backend registry: one experiment grid, pluggable executors.

A *backend* answers the question "what does this allreduce experiment cell
measure?" — the packet engine answers it by dispatching every packet as a
discrete event (exact, the reference), a flow-level model answers it by
solving a bandwidth-sharing problem over the same topology (approximate,
orders of magnitude faster at paper scale). Both consume the same
*work-item* dicts that ``benchmarks/sweep.py`` expands a suite into::

    {label, algo, n_trees, congestion, num_hosts, data_bytes, rep,
     topology, cfg: dataclasses.asdict(SimConfig), [lb]}

and both produce the same cell dicts (``label``/``rep``/``goodput_gbps``/
``runtime_us``/``correct``/``wall_s`` plus backend-specific diagnostics),
so sweeps, figures and the validation harness can swap executors with a
string.

The registry follows the ``ALGORITHMS`` / ``TOPOLOGIES`` pattern: a
string-keyed dict of *factories*. Factories (not instances) so that the
flow backend can defer its torch import until the first time someone
actually selects ``backend="flow"`` — ``import repro_torch.core.canary``
loads no torch (the contract pinned by ``tests/test_torch_flow.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Protocol


class Backend(Protocol):
    """What a simulation backend must provide."""

    name: str

    def run_cells(self, items: List[dict]) -> List[dict]:
        """Execute a list of sweep work items, one result dict per item
        (same order). Implementations may batch across items."""
        ...


BACKENDS: Dict[str, Callable[[], "Backend"]] = {}


def register_backend(name: str):
    """Class/factory decorator: ``@register_backend("mine")`` over a zero-arg
    callable returning a :class:`Backend`."""

    def deco(factory: Callable[[], "Backend"]):
        BACKENDS[name] = factory
        return factory

    return deco


def get_backend(name: str) -> "Backend":
    try:
        factory = BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r} "
                       f"(have: {', '.join(sorted(BACKENDS))})") from None
    return factory()


def item_config(item: dict):
    """Reconstruct the :class:`SimConfig` a work item describes (shared by
    every backend so they simulate the *same* world)."""
    from .types import SimConfig
    cfg = SimConfig(**item["cfg"])
    if "lb" in item:
        cfg = dataclasses.replace(cfg, lb=item["lb"])
    return cfg


@register_backend("packet")
class PacketBackend:
    """The discrete-event reference: exact packet-level execution."""

    name = "packet"

    def run_cell(self, item: dict) -> dict:
        from .algorithms import run_allreduce
        from .types import Algo
        cfg = item_config(item)
        t0 = time.perf_counter()
        # rep0 makes sweep cell r identical to rep r of a serial
        # run_allreduce(reps=R) call — one rep per work item, so a pool
        # load-balances cells, not whole experiments
        res = run_allreduce(cfg, Algo(item["algo"]), item["num_hosts"],
                            item["data_bytes"], n_trees=item["n_trees"],
                            congestion=item["congestion"], reps=1,
                            rep0=item["rep"])
        wall = time.perf_counter() - t0
        cell = dict(label=item["label"], rep=item["rep"],
                    goodput_gbps=res.goodput_gbps_mean,
                    runtime_us=res.runtime_us_mean,
                    avg_utilization=res.avg_utilization,
                    correct=res.correct,
                    events=res.reps[0].events,
                    wall_s=wall)
        if cfg.telemetry:
            cell["telemetry"] = res.reps[0].telemetry_summary
        return cell

    def run_cells(self, items: List[dict]) -> List[dict]:
        return [self.run_cell(it) for it in items]


@register_backend("flow")
def _flow_backend():
    # lazy: pulling the flow backend is what (eventually) pulls torch
    from ..flow import FlowBackend
    return FlowBackend()


def run_cells(items: List[dict], backend: str = "packet") -> List[dict]:
    """Convenience one-shot: ``get_backend(backend).run_cells(items)``."""
    return get_backend(backend).run_cells(items)
