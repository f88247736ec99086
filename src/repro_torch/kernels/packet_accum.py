"""Packet -> descriptor accumulation (port of ``repro/kernels/packet_accum.py``).

The hot loop of the paper's data plane (§3.1.1): every arriving packet's
payload is summed into the descriptor slot its block id hashes to, a
segment-sum. On a CUDA tensor the wrapper launches the deterministic
segmented reduction of ``csrc/packet_accum.cu``; on a CPU tensor it runs
:func:`.ref.packet_accumulate_ref`.

Accumulation dtype follows the payload: int32 payloads accumulate (and
return) int32 — the associative fixed-point path that makes dynamic-tree
replay bit-deterministic — while float payloads accumulate in float32.
"""
from __future__ import annotations

import torch

from . import _build
from .fixedpoint import check_cuda_tensor
from .ref import packet_accumulate_ref

_ACCUM_FN = {torch.int32: "repro_packet_accumulate_i32",
             torch.float32: "repro_packet_accumulate_f32",
             torch.bfloat16: "repro_packet_accumulate_bf16"}
_MAX_COL_BLOCKS = 65535   # gridDim.y of the kernel (256 columns a block)


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


def csr_by_slot(slot_ids: torch.Tensor, num_slots: int):
    """``(order, offsets)``: row indices stably sorted by slot, and the
    ``num_slots + 1`` offsets of each slot's run in ``order`` (the running
    count of rows per slot). Ids outside ``[0, num_slots)`` sort past the
    last offset, so the kernel never reads them."""
    ids = slot_ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_slots), ids, num_slots)
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.arange(num_slots + 1, dtype=torch.int64, device=ids.device)
    offsets = torch.searchsorted(sorted_ids, bounds)
    return order.to(torch.int32), offsets.to(torch.int32)


def packet_accumulate(slot_ids: torch.Tensor, payloads: torch.Tensor,
                      num_slots: int) -> torch.Tensor:
    """slot_ids: ``(N,)`` int; payloads: ``(N, D)`` -> ``(num_slots, D)``.

    Output dtype is :func:`accumulate_dtype` of the payload dtype. Ids
    outside ``[0, num_slots)`` hit nothing.
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
    n, d = payloads.shape
    if n >= 2 ** 31 or num_slots >= 2 ** 31 or -(-d // 256) > _MAX_COL_BLOCKS:
        raise ValueError(f"shape (N={n}, D={d}, slots={num_slots}) exceeds "
                         f"the kernel's grid")
    out = torch.empty((num_slots, d), dtype=acc, device=payloads.device)
    if num_slots == 0 or d == 0:
        return out
    with torch.cuda.device(payloads.device):
        order, offsets = csr_by_slot(slot_ids, num_slots)
        fn = getattr(_build.library(), _ACCUM_FN[payloads.dtype])
        _build.check(fn(payloads.data_ptr(), order.data_ptr(),
                        offsets.data_ptr(), out.data_ptr(), num_slots, d,
                        torch.cuda.current_stream().cuda_stream),
                     "packet_accumulate")
    packet_accumulate.launches += 1
    return out


packet_accumulate.launches = 0
