"""Packet -> descriptor accumulation (port of ``repro/kernels/packet_accum.py``).

The hot loop of the paper's data plane (§3.1.1): every arriving packet's
payload is summed into the descriptor slot its block id hashes to, a
segment-sum. Two entry points, both on the deterministic segmented
reductions of ``csrc/packet_accum.cu`` for a CUDA tensor and on the plain
versions of :mod:`.ref` for a CPU tensor:

* :func:`packet_accumulate` — rows by slot id, one launch a call;
* :func:`packet_accumulate_gather` — one height level of a replay plan
  (:mod:`repro_torch.core.trace.plan`) over every block of an app, one
  launch a level: the trace executor's reduce.

Accumulation dtype follows the payload: int32 payloads accumulate (and
return) int32 — the associative fixed-point path that makes dynamic-tree
replay bit-deterministic — while float payloads accumulate in float32.
"""
from __future__ import annotations

import torch

from . import _build
from .fixedpoint import check_cuda_tensor
from .ref import packet_accumulate_gather_ref, packet_accumulate_ref

_ACCUM_FN = {torch.int32: "repro_packet_accumulate_i32",
             torch.float32: "repro_packet_accumulate_f32",
             torch.bfloat16: "repro_packet_accumulate_bf16"}
_GATHER_FN = {torch.int32: "repro_packet_accumulate_gather_i32",
              torch.float32: "repro_packet_accumulate_gather_f32"}
_MAX_COL_BLOCKS = 65535   # gridDim.y: column tiles of 32 values or more


def accumulate_dtype(payload_dtype: torch.dtype) -> torch.dtype:
    """int32 payloads accumulate in int32 (associative); floats in float32.

    Other integer dtypes are rejected: casting them to int32 would silently
    wrap (int64/uint32) and the fixed-point contract is int32-exact.
    """
    if payload_dtype.is_floating_point:
        return torch.float32
    if payload_dtype != torch.int32:
        raise TypeError(f"integer payloads must be int32 (got {payload_dtype});"
                        f" quantize via repro_torch.kernels.fixedpoint first")
    return torch.int32


def packet_accumulate(slot_ids: torch.Tensor, payloads: torch.Tensor,
                      num_slots: int) -> torch.Tensor:
    """slot_ids: ``(N,)`` int; payloads: ``(N, D)`` -> ``(num_slots, D)``.

    Output dtype is :func:`accumulate_dtype` of the payload dtype. Ids
    outside ``[0, num_slots)`` hit nothing. On CUDA the kernel reads int32
    and int64 ids as they are; other integer ids are widened to int64 first.
    """
    if payloads.dim() != 2 or slot_ids.dim() != 1 \
            or slot_ids.shape[0] != payloads.shape[0]:
        raise ValueError(f"need slot_ids (N,) and payloads (N, D); got "
                         f"{tuple(slot_ids.shape)} and {tuple(payloads.shape)}")
    acc = accumulate_dtype(payloads.dtype)
    if payloads.device.type == "cpu":
        return packet_accumulate_ref(slot_ids, payloads, num_slots)
    check_cuda_tensor(payloads, "payloads")
    if slot_ids.device != payloads.device:
        raise ValueError(f"slot_ids on {slot_ids.device}, payloads on "
                         f"{payloads.device}")
    if payloads.dtype not in _ACCUM_FN:
        raise TypeError(f"packet_accumulate takes int32, float32 or bfloat16 "
                        f"on CUDA, got {payloads.dtype}")
    if slot_ids.dtype.is_floating_point or slot_ids.dtype == torch.bool:
        raise TypeError(f"slot_ids must be integers, got {slot_ids.dtype}")
    if slot_ids.dtype not in (torch.int32, torch.int64):
        slot_ids = slot_ids.to(torch.int64)
    slot_ids = slot_ids.contiguous()
    n, d = payloads.shape
    if num_slots >= 2 ** 31 - 256 or -(-d // 32) > _MAX_COL_BLOCKS:
        raise ValueError(f"shape (N={n}, D={d}, slots={num_slots}) exceeds "
                         f"the kernel's grid")
    out = torch.empty((num_slots, d), dtype=acc, device=payloads.device)
    if num_slots == 0 or d == 0:
        return out
    with torch.cuda.device(payloads.device):
        fn = getattr(_build.library(), _ACCUM_FN[payloads.dtype])
        _build.check(fn(payloads.data_ptr(), slot_ids.data_ptr(),
                        slot_ids.element_size(), n, num_slots, d,
                        out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream),
                     "packet_accumulate")
    packet_accumulate.launches += 1
    return out


def packet_accumulate_gather(leaf: torch.Tensor, scratch: torch.Tensor,
                             out: torch.Tensor, seg_offsets: torch.Tensor,
                             src: torch.Tensor, dst: torch.Tensor) -> None:
    """One level of a replay plan, in place: ``out[dst[s]] = sum of the rows
    src[seg_offsets[s]:seg_offsets[s + 1]]``.

    ``leaf``: the ``(P * B, D)`` input rows (``src >= 0``); ``scratch``: the
    ``(rows, D)`` switch-node table, read at ``src = -1 - r`` and written at
    ``dst >= 0``; ``out``: ``(P, B, D)``, whose rows ``out[:, b]`` all take
    the sum of the segment with ``dst = -1 - b``. The index arrays are the
    plan's int32 tensors (:meth:`~repro_torch.core.trace.plan.ReplayPlan.on`).
    All three tensors share one dtype, int32 or float32.
    """
    if leaf.dim() != 2 or scratch.dim() != 2 or out.dim() != 3 \
            or not leaf.shape[1] == scratch.shape[1] == out.shape[2] \
            or leaf.shape[0] != out.shape[0] * out.shape[1]:
        raise ValueError(f"need leaf (P*B, D), scratch (R, D), out (P, B, D);"
                         f" got {tuple(leaf.shape)}, {tuple(scratch.shape)},"
                         f" {tuple(out.shape)}")
    if not leaf.dtype == scratch.dtype == out.dtype \
            or leaf.dtype not in _GATHER_FN:
        raise TypeError(f"packet_accumulate_gather takes int32 or float32 "
                        f"tensors of one dtype, got {leaf.dtype}, "
                        f"{scratch.dtype}, {out.dtype}")
    if leaf.device.type == "cpu":
        packet_accumulate_gather_ref(leaf, scratch, out, seg_offsets, src, dst)
        return
    index = (seg_offsets, src, dst)
    for name, t in zip(("leaf", "scratch", "out", "seg_offsets", "src",
                        "dst"), (leaf, scratch, out) + index):
        check_cuda_tensor(t, name)
        if t.device != leaf.device:
            raise ValueError(f"{name} on {t.device}, leaf on {leaf.device}")
    if any(t.dtype != torch.int32 for t in index):
        raise TypeError("the plan's index arrays must be int32")
    p, b, d = out.shape
    num_segments = dst.shape[0]
    if num_segments == 0 or d == 0:
        return
    if -(-d // 32) > _MAX_COL_BLOCKS:
        raise ValueError(f"D={d} exceeds the kernel's grid")
    with torch.cuda.device(leaf.device):
        fn = getattr(_build.library(), _GATHER_FN[leaf.dtype])
        _build.check(fn(leaf.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                        seg_offsets.data_ptr(), src.data_ptr(),
                        dst.data_ptr(), num_segments, d, p, b,
                        torch.cuda.current_stream().cuda_stream),
                     "packet_accumulate_gather")
    packet_accumulate_gather.launches += 1


packet_accumulate.launches = 0
packet_accumulate_gather.launches = 0
