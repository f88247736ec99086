"""Tensor executor: replay compiled schedules on the card (port of
``repro/core/trace/executor.py``).

The schedules are lowered once into a :class:`~.plan.ReplayPlan`, which
merges the same reduce round (height level) of every block into one
gathered segment-sum: :func:`repro_torch.kernels.packet_accumulate_gather`
sums each switch node's children into a scratch table, the per-switch
aggregation of §3.1.1, one launch per level for the whole app. A root's sum
is written to every participant's row, the broadcast down the mirrored
tree (§3.1.2). Nothing per round reaches the host.

Two numeric modes:

* **float32** — matches a plain ``sum(inputs)`` up to re-association error
  (the tree decides the association order).
* **int32 fixed point** — inputs are quantized with
  :func:`repro_torch.kernels.quantize` and accumulated as int32. Integer
  addition is associative, so the result is **bit-identical for every tree
  shape the timeouts produced**.

``replay_app`` and ``fixed_point_replay`` take the schedules or their plan
(:func:`~.plan.lower_schedules`); given schedules they lower them on every
call. The entry points take ``device=None``, which means ``"cuda"``; inputs
may be numpy arrays or tensors and are moved there.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from ...kernels.fixedpoint import dequantize, quantize
from ...kernels.ops import fixed_point_scale, resolve_device
from ...kernels.packet_accum import accumulate_dtype, packet_accumulate_gather
from .plan import ReplayPlan, lower_schedules
from .schedule import Schedule

Replayable = Union[ReplayPlan, Sequence[Schedule]]


def _plan(schedules: Replayable) -> ReplayPlan:
    if isinstance(schedules, ReplayPlan):
        return schedules
    return lower_schedules(schedules)


def run_plan(plan: ReplayPlan, inputs: torch.Tensor, *,
             gather=packet_accumulate_gather) -> torch.Tensor:
    """Every level of ``plan`` over ``inputs`` ``(P, B, D)`` through
    ``gather`` (the wrapper by default; the checks on the card hand in its
    plain version); returns the ``(P, B, D)`` result."""
    if inputs.dim() != 3 or inputs.shape[:2] != (plan.hosts, plan.blocks):
        raise ValueError(f"inputs of shape {tuple(inputs.shape)} for "
                         f"{plan.blocks} schedules of {plan.hosts} "
                         f"participants; need (P, B, D)")
    p, nb, d = inputs.shape
    leaf = inputs.to(accumulate_dtype(inputs.dtype)).contiguous()
    scratch = torch.empty((plan.scratch_rows, d), dtype=leaf.dtype,
                          device=leaf.device)
    out = torch.empty_like(leaf)
    leaf = leaf.view(p * nb, d)
    for level in plan.on(leaf.device):
        gather(leaf, scratch, out, *level)
    return out


def replay_block(schedule: Schedule, inputs, *, device=None) -> torch.Tensor:
    """Replay one block's schedule over per-host input rows.

    ``inputs``: ``(P, D)`` — row ``r`` is the contribution of
    ``schedule.hosts[r]``. Returns ``(P, D)``: every host's post-broadcast
    buffer (all rows identical — the reduced block). int32 inputs are
    accumulated in int32 (associative), floats in float32.
    """
    dev = resolve_device(device)
    inputs = torch.as_tensor(inputs, device=dev)
    if inputs.dim() != 2 or inputs.shape[0] != len(schedule.hosts):
        raise ValueError(f"inputs of shape {tuple(inputs.shape)} for "
                         f"{len(schedule.hosts)} participants; need (P, D)")
    return run_plan(lower_schedules([schedule]), inputs[:, None])[:, 0]


def replay_app(schedules: Replayable, inputs, *,
               device=None) -> torch.Tensor:
    """Replay a whole app: ``inputs`` is ``(P, B, D)`` (one row of blocks per
    participant, in ``schedules[b].hosts`` order); returns ``(P, B, D)``.
    ``schedules`` may be their :class:`~.plan.ReplayPlan`."""
    dev = resolve_device(device)
    return run_plan(_plan(schedules), torch.as_tensor(inputs, device=dev))


def fixed_point_replay(schedules: Replayable, x, *, bits: int = 24,
                       device=None):
    """Fixed-point replay: quantize -> int32 tree accumulation -> dequantize.

    ``x``: ``(P, B, D)`` float inputs; ``schedules`` may be their
    :class:`~.plan.ReplayPlan`. Returns ``(result, q_result)`` where
    ``q_result`` is the raw ``(P, B, D)`` int32 accumulation — bit-identical
    across any set of recorded tree shapes for the same ``x`` — and
    ``result`` is its dequantized float32 view. The scale is the shared
    :func:`~repro_torch.kernels.ops.fixed_point_scale` with headroom for
    ``P`` summands; it stays on the device (the kernels read it through a
    pointer), so the host never waits for it.
    """
    dev = resolve_device(device)
    plan = _plan(schedules)
    x = torch.as_tensor(x, device=dev).contiguous()
    lo, hi = torch.aminmax(x.to(torch.float32))  # max |x| in one pass
    gmax = torch.maximum(hi, -lo)
    scale = fixed_point_scale(gmax, bits=bits, world=x.shape[0])
    q = quantize(x, scale)
    q_result = run_plan(plan, q)
    return dequantize(q_result, scale), q_result


def reference_allreduce(x, *, device=None) -> torch.Tensor:
    """The float oracle: every participant receives ``sum_r x[r]``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    total = torch.sum(x.to(torch.float32), dim=0)
    return total.expand(x.shape)
