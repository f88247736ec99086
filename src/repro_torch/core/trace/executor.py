"""Tensor executor: replay compiled schedules on the card (port of
``repro/core/trace/executor.py``).

Each reduce round of a :class:`~.schedule.Schedule` is one segment-sum:
every step's source buffers are stacked into a packet matrix and
accumulated into per-destination slots by
:func:`repro_torch.kernels.packet_accumulate`, the per-switch aggregation of
§3.1.1. The broadcast phase replicates the root buffer down the mirrored
tree (§3.1.2).

Two numeric modes:

* **float32** — matches a plain ``sum(inputs)`` up to re-association error
  (the tree decides the association order).
* **int32 fixed point** — inputs are quantized with
  :func:`repro_torch.kernels.quantize` and accumulated as int32. Integer
  addition is associative, so the result is **bit-identical for every tree
  shape the timeouts produced**.

The entry points take ``device=None``, which means ``"cuda"``; inputs may be
numpy arrays or tensors and are moved there.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ...kernels.fixedpoint import dequantize, quantize
from ...kernels.ops import fixed_point_scale, resolve_device
from ...kernels.packet_accum import accumulate_dtype, packet_accumulate
from .schedule import Schedule


def _replay_block(schedule: Schedule, inputs: torch.Tensor) -> torch.Tensor:
    hosts = schedule.hosts
    if inputs.dim() != 2 or inputs.shape[0] != len(hosts):
        raise ValueError(f"inputs of shape {tuple(inputs.shape)} for "
                         f"{len(hosts)} participants; need (P, D)")
    rank = {h: r for r, h in enumerate(hosts)}
    inputs = inputs.to(accumulate_dtype(inputs.dtype))

    buffers = {}
    for nid, host in schedule.leaf_host.items():
        buffers[nid] = inputs[rank[host]]

    for rnd in schedule.reduce_rounds:
        slot_ids = []
        payloads = []
        for slot, step in enumerate(rnd):
            for src in step.srcs:
                slot_ids.append(slot)
                payloads.append(buffers[src])
        acc = packet_accumulate(
            torch.tensor(slot_ids, dtype=torch.int32, device=inputs.device),
            torch.stack(payloads), len(rnd))
        for slot, step in enumerate(rnd):
            buffers[step.dst] = acc[slot]

    # broadcast: every step of the mirrored tree is a copy of the root
    # buffer, so the per-host rows materialize directly
    total = buffers[schedule.root]
    return total.expand((len(hosts),) + tuple(total.shape))


def _replay_app(schedules: Sequence[Schedule],
                inputs: torch.Tensor) -> torch.Tensor:
    if inputs.dim() != 3 or inputs.shape[1] != len(schedules):
        raise ValueError(f"inputs of shape {tuple(inputs.shape)} for "
                         f"{len(schedules)} schedules; need (P, B, D)")
    outs = [_replay_block(s, inputs[:, b]) for b, s in enumerate(schedules)]
    return torch.stack(outs, dim=1)


def replay_block(schedule: Schedule, inputs, *, device=None) -> torch.Tensor:
    """Replay one block's schedule over per-host input rows.

    ``inputs``: ``(P, D)`` — row ``r`` is the contribution of
    ``schedule.hosts[r]``. Returns ``(P, D)``: every host's post-broadcast
    buffer (all rows identical — the reduced block). int32 inputs are
    accumulated in int32 (associative), floats in float32.
    """
    dev = resolve_device(device)
    return _replay_block(schedule, torch.as_tensor(inputs, device=dev))


def replay_app(schedules: Sequence[Schedule], inputs, *,
               device=None) -> torch.Tensor:
    """Replay a whole app: ``inputs`` is ``(P, B, D)`` (one row of blocks per
    participant, in ``schedules[b].hosts`` order); returns ``(P, B, D)``."""
    dev = resolve_device(device)
    return _replay_app(schedules, torch.as_tensor(inputs, device=dev))


def fixed_point_replay(schedules: Sequence[Schedule], x, *, bits: int = 24,
                       device=None):
    """Fixed-point replay: quantize -> int32 tree accumulation -> dequantize.

    ``x``: ``(P, B, D)`` float inputs. Returns ``(result, q_result)`` where
    ``q_result`` is the raw ``(P, B, D)`` int32 accumulation — bit-identical
    across any set of recorded tree shapes for the same ``x`` — and
    ``result`` is its dequantized float32 view. The scale is the shared
    :func:`~repro_torch.kernels.ops.fixed_point_scale` with headroom for
    ``P`` summands; it stays on the device (the kernels read it through a
    pointer), so the host never waits for it.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev).contiguous()
    gmax = torch.max(torch.abs(x.to(torch.float32)))
    scale = fixed_point_scale(gmax, bits=bits, world=x.shape[0])
    q = quantize(x, scale)
    q_result = _replay_app(schedules, q)
    return dequantize(q_result, scale), q_result


def reference_allreduce(x, *, device=None) -> torch.Tensor:
    """The float oracle: every participant receives ``sum_r x[r]``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    total = torch.sum(x.to(torch.float32), dim=0)
    return total.expand(x.shape)
