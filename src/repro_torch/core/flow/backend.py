"""The ``"flow"`` entry of the simulation-backend registry.

``FlowBackend.run_cells`` is the drop-in counterpart of the packet
backend's: same work-item dicts in, same cell-dict schema out
(label/rep/goodput_gbps/runtime_us/correct/wall_s) — with flow-specific
diagnostics instead of event counts: which bound held (``bw`` vs ``mix``),
the mixed noise share the cell saw, and the batch-level solve accounting
(``jit_calls``/``jit_traces``, the reference's names) that the sweep JSON
records as evidence the matrix ran as one batched solve. The solve runs on
the card unless the backend is built with ``device="cpu"``.

``correct`` is reported as True by construction: the flow model does not
move payload bits, so there is no end-to-end sum to check — correctness of
the *predictions* is what ``validate.py`` enforces against the packet
engine instead.
"""
from __future__ import annotations

import time
from typing import List

from ...kernels.ops import resolve_device
from . import batch
from .model import lower_item, solve_cell


class FlowBackend:
    name = "flow"

    def __init__(self, device=None) -> None:
        self.jit_calls = 0
        self.device = resolve_device(device)

    def run_cells(self, items: List[dict]) -> List[dict]:
        t0 = time.perf_counter()
        cells = [lower_item(it) for it in items]
        lower_s = time.perf_counter() - t0
        traces0 = batch.trace_count()
        t1 = time.perf_counter()
        runtimes_ns, goodputs = batch.run_batch(cells, self.device)
        solve_s = time.perf_counter() - t1
        self.jit_calls += 1
        traces = batch.trace_count() - traces0
        per_cell_wall = (lower_s + solve_s) / max(1, len(items))
        out = []
        for item, cell, t_ns, gp in zip(items, cells, runtimes_ns, goodputs):
            t_py, _ = solve_cell(cell)
            bound = "bw" if t_py > 0 and _bw_bound(cell) >= \
                cell.t_send_ns * (1.0 + cell.mu * cell.g_mix) else "mix"
            out.append(dict(label=item["label"], rep=item["rep"],
                            goodput_gbps=gp,
                            runtime_us=t_ns / 1e3,
                            correct=True,
                            backend="flow", bound=bound,
                            g_mix=round(cell.g_mix, 4),
                            t_send_us=cell.t_send_ns / 1e3,
                            jit_traces=traces,
                            wall_s=per_cell_wall))
        return out


def _bw_bound(cell) -> float:
    t = 0.0
    for load, g in zip(cell.link_load_bytes, cell.link_noise_frac):
        avail = min(1.0, max(1.0 - cell.kappa * g, cell.floor))
        t = max(t, load / (cell.bytes_per_ns * avail))
    return t
