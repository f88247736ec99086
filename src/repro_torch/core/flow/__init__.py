"""Flow-level fast path: predict allreduce runtime without dispatching packets.

The packet engine (``repro_torch.core.canary``) is the exact reference:
every packet is a discrete event, so a paper-scale (1024-host, 4 MiB) cell
costs tens of millions of Python events. This package trades exactness for
orders-of-magnitude speed: each experiment cell is *lowered* to a small
bandwidth-sharing problem over the aggregation tree's link classes
(``model.py``), the whole sweep matrix is stacked into padded tensors, and
one batched PyTorch solve computes every cell x rep at once, on the card
unless the caller asks for the CPU (``batch.py``). Calibration constants
pinning the model to the packet engine live in ``calibrate.py``; the
divergence contract is enforced by ``validate.py`` over the sweep grids of
``suites.py``.

Import contract: ``import repro_torch.core.flow`` must NOT import torch —
the lowering and calibration are pure Python, and only :class:`FlowBackend`
/ ``run_batch`` pull torch on first use (PEP 562). This keeps
``repro_torch.core.canary``'s backend registry — which maps ``"flow"`` to
this package — torch-free until someone actually selects the flow backend.
"""
from .calibrate import CALIBRATION, FamilyParams, params_for
from .model import FlowCell, lower_item

_LAZY_BACKEND = ("FlowBackend", "run_batch", "trace_count")

__all__ = ["CALIBRATION", "FamilyParams", "FlowBackend", "FlowCell",
           "lower_item", "params_for", "run_batch", "trace_count"]


def __getattr__(name: str):
    if name in ("run_batch", "trace_count"):
        from . import batch
        return getattr(batch, name)
    if name == "FlowBackend":
        from .backend import FlowBackend
        return FlowBackend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
