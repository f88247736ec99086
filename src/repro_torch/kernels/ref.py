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


def packet_accumulate_gather_ref(leaf: torch.Tensor, scratch: torch.Tensor,
                                 out: torch.Tensor, seg_offsets: torch.Tensor,
                                 src: torch.Tensor, dst: torch.Tensor) -> None:
    """One level of a replay plan, in place (the plain version of
    ``packet_accumulate_gather``): segment ``s`` sums the rows
    ``src[seg_offsets[s]:seg_offsets[s + 1]]``, each a row of ``leaf``
    (``>= 0``) or of ``scratch`` (``-1 - r``), in ``src`` order, and writes
    ``scratch[dst[s]]``, or every ``out[:, b]`` where ``dst[s] = -1 - b``."""
    dev = leaf.device
    seg_offsets, src, dst = (t.to(device=dev, dtype=torch.int64)
                             for t in (seg_offsets, src, dst))
    rows = torch.empty((src.shape[0], leaf.shape[1]), dtype=leaf.dtype,
                       device=dev)
    from_leaf = src >= 0
    rows[from_leaf] = leaf[src[from_leaf]]
    rows[~from_leaf] = scratch[-1 - src[~from_leaf]]
    seg = torch.repeat_interleave(torch.arange(dst.shape[0], device=dev),
                                  seg_offsets.diff())
    sums = torch.zeros((dst.shape[0], leaf.shape[1]), dtype=leaf.dtype,
                       device=dev).index_add_(0, seg, rows)
    to_scratch = dst >= 0
    scratch[dst[to_scratch]] = sums[to_scratch]
    out[:, -1 - dst[~to_scratch]] = sums[~to_scratch]


def _attention_logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
                      window: int) -> torch.Tensor:
    """Float32 logits ``(B, KV, H // KV, S, S)`` of q ``(B, H, S, D)`` and k
    ``(B, KV, S, D)``, ``-1e30`` where masked: ``kpos <= qpos`` when
    ``causal``, and ``kpos > qpos - window`` when ``window > 0`` (the
    sliding-window term of ``chunked_attention``)."""
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
    return torch.where(mask, logits, -1e30)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """GQA attention with materialised float32 logits.

    q: ``(B, H, S, D)``; k, v: ``(B, KV, S, D)`` with ``H % KV == 0``.
    Masked logits are ``-1e30`` (see :func:`_attention_logits`). Returns
    ``(B, H, S, D)`` in q's dtype and, with ``return_lse``, also each row's
    float32 log-sum-exp of the logits, ``(B, H, S)``.
    """
    B, H, S, D = q.shape
    logits = _attention_logits(q, k, causal, window)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.to(torch.float32))
    out = out.reshape(B, H, S, D).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1).reshape(B, H, S)
    return out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True, window: int = 0):
    """The gradient of :func:`flash_attention_ref` from its output and
    log-sum-exp: ``(dq, dk, dv)`` in the dtypes of q, k and v.

    In float32: ``p = exp(s - lse)`` (0 where masked), ``delta =
    rowsum(dout * out)``, ``ds = p * (dout v^T - delta)``, ``dq = ds k /
    sqrt(D)``, ``dk = ds^T q / sqrt(D)`` and ``dv = p^T dout``, dk and dv
    summed over the ``H // KV`` query heads of each key head.
    """
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    s = _attention_logits(q, k, causal, window)
    p = torch.exp(s - lse.reshape(B, KV, G, S, 1).to(torch.float32))
    g = dout.reshape(B, KV, G, S, D).to(torch.float32)
    delta = (g * out.reshape(B, KV, G, S, D).to(torch.float32)).sum(-1)
    dp = torch.einsum("bkgqd,bksd->bkgqs", g, v.to(torch.float32))
    ds = p * (dp - delta[..., None])
    qg = q.reshape(B, KV, G, S, D).to(torch.float32)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds,
                      k.to(torch.float32)) / math.sqrt(D)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) / math.sqrt(D)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, g)
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
