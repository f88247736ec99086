"""Plain PyTorch versions of the kernels (the reference the kernels are held to).

Each takes tensors on any device: the CPU tests run them against the JAX
package's oracles, and ``chip_smoke.py`` runs them on the card beside the
kernels. The scale of the fixed-point pair is a float32 tensor (or a Python
float, made float32), so the arithmetic is float32 throughout, as in
``jnp``.
"""
from __future__ import annotations

import math

import torch


def scale_tensor(scale, device: torch.device) -> torch.Tensor:
    """The scale (a float or a 1-element tensor) as a float32 tensor on
    ``device``; the kernels read it there through a pointer."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=device)
    if s.numel() != 1:
        raise ValueError(f"scale must be a scalar, got {s.numel()} values")
    return s


def quantize_ref(x: torch.Tensor, scale) -> torch.Tensor:
    """Float -> fixed-point int32: ``int32(round_half_even(f32(x) * scale))``."""
    s = scale_tensor(scale, x.device)
    return torch.round(x.to(torch.float32) * s).to(torch.int32)


def dequantize_ref(q: torch.Tensor, scale) -> torch.Tensor:
    """``f32(q) / scale`` as an IEEE division (tensor by tensor: a Python
    scalar divisor may be applied as a reciprocal product)."""
    return torch.div(q.to(torch.float32), scale_tensor(scale, q.device))


def packet_accumulate_ref(slot_ids: torch.Tensor, payloads: torch.Tensor,
                          num_slots: int) -> torch.Tensor:
    """Segment-sum of payload rows into descriptor slots (paper §3.1.1).

    ``slot_ids``: ``(N,)``; ``payloads``: ``(N, D)``. Returns
    ``(num_slots, D)`` in :func:`accumulate_dtype` of the payload dtype. Ids
    outside ``[0, num_slots)`` are dropped, as ``jax.ops.segment_sum`` drops
    them (the Pallas wrapper pads with id ``num_slots``).
    """
    from .packet_accum import accumulate_dtype
    acc = accumulate_dtype(payloads.dtype)
    ids = slot_ids.to(torch.int64)
    keep = (ids >= 0) & (ids < num_slots)
    out = torch.zeros((num_slots, payloads.shape[1]), dtype=acc,
                      device=payloads.device)
    return out.index_add_(0, ids[keep], payloads[keep].to(acc))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA attention with materialised float32 logits.

    q: ``(B, H, S, D)``; k, v: ``(B, KV, S, D)`` with ``H % KV == 0``.
    Masked logits are ``-1e30``: ``kpos <= qpos`` when ``causal``, and
    ``kpos > qpos - window`` when ``window > 0`` (the sliding-window term of
    ``chunked_attention``). Returns ``(B, H, S, D)`` in q's dtype.
    """
    B, H, S, D = q.shape
    KV = k.shape[1]
    qg = q.reshape(B, KV, H // KV, S, D).to(torch.float32)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg,
                          k.to(torch.float32)) / math.sqrt(D)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.to(torch.float32))
    return out.reshape(B, H, S, D).to(q.dtype)
