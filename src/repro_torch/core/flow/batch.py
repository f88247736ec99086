"""Batched PyTorch evaluation of lowered flow cells (port of
``repro/core/flow/batch.py``).

The whole sweep matrix — every (algorithm, congestion, rep) cell — becomes
ONE batched solve over padded tensors: link loads and noise shares are
stacked to ``[cells, max_links]`` (padding with zero load, which can never
win the max), scalars to ``[cells]``. At paper scale that is a ~[168, 290]
float32 problem — the cost of the flow backend is the Python lowering, not
the solve. The reference traces a ``jit(vmap)``-ed cell function once per
matrix; the port has no tracing, and ``trace_count()`` counts batched
solves instead, one per :func:`run_batch`, so a whole matrix still costs
exactly one (``tests/test_torch_flow.py``).

This module is the only part of the flow package that imports torch, and it
is imported lazily (``repro_torch.core.flow.__getattr__``). The solve runs
on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ...kernels.ops import resolve_device
from .model import FlowCell

_TRACE_COUNT = 0

SCALARS = ("kappa", "floor", "mu", "nu", "t_send_ns", "tail_ns", "g_mix",
           "bytes_per_ns", "data_bits")


def trace_count() -> int:
    """How many batched solves have run in this process. The batching
    contract: one per sweep matrix, however many cells x reps it holds."""
    return _TRACE_COUNT


def solve(load: torch.Tensor, g: torch.Tensor, s: dict):
    """Every cell at once: ``(runtime_ns, goodput_gbps)``, each ``[cells]``.

    The reference's ``_solve_one`` over the leading axis; mirrors
    ``model.solve_cell`` exactly — keep the two in lockstep.
    """
    global _TRACE_COUNT
    _TRACE_COUNT += 1
    avail = torch.maximum(1.0 - s["kappa"][:, None] * g,
                          s["floor"][:, None]).clamp(max=1.0)
    t_bw = torch.amax(load / (s["bytes_per_ns"][:, None] * avail), dim=1)
    t_mix = s["t_send_ns"] * (1.0 + s["mu"] * s["g_mix"])
    t = torch.maximum(t_bw, t_mix) + s["tail_ns"] * (1.0 + s["nu"] * s["g_mix"])
    return t, s["data_bits"] / t


def pack(cells: List[FlowCell], device=None):
    """Stack lowered cells into padded float32 tensors on ``device`` (pad
    links with load=0, noise=0: a zero-load link can never be the
    bottleneck). The host builds one ``[cells, 2 * max_links + 9]`` table
    and copies it over once."""
    dev = resolve_device(device)
    m = max(len(c.link_load_bytes) for c in cells)
    rows = [c.link_load_bytes + [0.0] * (m - len(c.link_load_bytes))
            + c.link_noise_frac + [0.0] * (m - len(c.link_noise_frac))
            + [getattr(c, name) for name in SCALARS] for c in cells]
    table = torch.tensor(rows, dtype=torch.float32).to(dev)
    scal = {name: table[:, 2 * m + i] for i, name in enumerate(SCALARS)}
    return table[:, :m], table[:, m:2 * m], scal


def run_batch(cells: List[FlowCell], device=None
              ) -> Tuple[List[float], List[float]]:
    """Solve every cell in one batched solve. Returns (runtime_ns[],
    goodput_gbps[]) as plain Python floats, cell order preserved, from one
    copy to the host."""
    if not cells:
        return [], []
    load, g, s = pack(cells, device)
    t, gp = solve(load, g, s)
    t_host, gp_host = torch.stack((t, gp)).cpu().tolist()
    return t_host, gp_host
