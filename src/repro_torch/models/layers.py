"""Core neural layers (port of ``repro/models/layers.py``): RMSNorm, RoPE /
M-RoPE, GQA attention (full, chunked online-softmax, cache decode) and dense
MLPs.

The reference keeps parameters in pytrees made by ``init_*`` helpers; here
each group is a small ``nn.Module`` (:class:`RMSNorm`, :class:`Attention`,
:class:`MLP`, :class:`Embeddings`) whose parameter names are the pytree's
keys, and the layer functions keep the reference's names and signatures,
reading those attributes. Shapes follow the reference's (batch, seq, heads,
head_dim) convention and its dtypes: RMSNorm and RoPE compute in float32
and cast back, attention logits are formed in the activations' dtype, then
softmaxed in float32.

``chunked_attention`` is where the port differs in form: it calls the
hand-written flash-attention kernel (:mod:`repro_torch.kernels`), which is
the same online-softmax recurrence with a float32 accumulator where the
reference's jnp scan keeps it in the activations' dtype.

Parameters never require a gradient in this slice: nothing here has a
backward, and the flash kernel refuses inputs that want one.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import flash_attention
from .config import ModelConfig


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _weights(module: nn.Module, shapes: dict, dtype, device,
             gen: Optional[torch.Generator]) -> None:
    """Register ``{name: (shape, scale)}`` on ``module``: with ``gen``,
    ``(normal(shape) * scale).astype(dtype)`` as ``jax.random.normal`` draws
    it (float32, then cast); without, uninitialised for a loader to fill."""
    for name, (shape, scale) in shapes.items():
        if gen is None:
            t = torch.empty(shape, dtype=dtype, device=device)
        else:
            t = (torch.randn(shape, generator=gen, dtype=torch.float32,
                             device=device) * scale).to(dtype)
        setattr(module, name, _param(t))


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a ``torch.dtype`` passes)."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# --------------------------------------------------------------------- norms
class RMSNorm(nn.Module):
    """``{"scale": (d,)}``; the scale is float32 whatever the model dtype,
    as ``init_rmsnorm``'s default keeps it."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _param(torch.ones((d,), dtype=torch.float32,
                                       device=device))


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * p.scale.to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of ``x`` (B, S, H, D) by ``ang`` (B, S, D/2)."""
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Standard rotary embedding. x: (B, S, H, D); positions: (B, S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191 §3.1).

    The head_dim/2 frequency slots are split into (t, h, w) sections; each
    section rotates by its own position stream. ``positions3``: (B, S, 3).
    For pure text all three streams are equal and M-RoPE == RoPE.
    """
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec_ids = torch.cat([torch.full((s,), i, dtype=torch.int64,
                                    device=x.device)
                         for i, s in enumerate(sections)])
    pos = positions3.to(torch.float32)[..., sec_ids]             # (B, S, half)
    return _rotate(x, pos * freqs)


# ------------------------------------------------------------------ attention
class Attention(nn.Module):
    """``wq (d, h, hd)``, ``wk``/``wv (d, kv, hd)``, ``wo (h, hd, d)`` and,
    with ``qkv_bias``, zero ``bq``/``bk``/``bv``."""

    def __init__(self, cfg: ModelConfig, dtype, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        scale = d ** -0.5
        _weights(self, {"wq": ((d, h, hd), scale), "wk": ((d, kv, hd), scale),
                        "wv": ((d, kv, hd), scale),
                        "wo": ((h, hd, d), (h * hd) ** -0.5)},
                 dtype, device, gen)
        if cfg.qkv_bias:
            for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
                setattr(self, name, _param(torch.zeros(
                    (n, hd), dtype=dtype, device=device)))


def _gqa_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, D), k: (B, Sk, KV, D) -> logits (B, KV, G, Sq, Sk), in
    q's dtype, divided by sqrt(D) rounded to that dtype."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    # a 0-dim CPU tensor is passed to a CUDA op as a scalar, without a copy
    root = torch.tensor(math.sqrt(D), dtype=torch.float32).to(q.dtype)
    return torch.einsum("bqkgd,bskd->bkgqs", qg, k) / root


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B, KV, G, Sq, Sk), v: (B, Sk, KV, D) -> (B, Sq, H, D)."""
    B, KV, G, Sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, KV * G, -1)


def full_attention(q, k, v, *, causal: bool,
                   sliding_window: int = 0) -> torch.Tensor:
    """Materialized-logits attention (short sequences)."""
    Sq, Sk = q.shape[1], k.shape[1]
    logits = _gqa_logits(q, k).to(torch.float32)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window > 0:
        mask &= kpos > qpos - sliding_window
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _gqa_out(probs, v)


def chunked_attention(q, k, v, *, causal: bool, chunk: int = 1024,
                      sliding_window: int = 0) -> torch.Tensor:
    """Online-softmax attention (the FlashAttention recurrence) through the
    port's flash kernel: one launch for the whole sequence.

    q: (B, S, H, D); k, v: (B, S, KV, D). The kernel reads the
    (B, H, S, D) transposes through their strides and picks its own tiles,
    so ``chunk`` sets nothing but the reference's divisibility rule; fully
    masked tiles (causal or out of the window) are skipped.
    """
    S = q.shape[1]
    assert S % chunk == 0, (S, chunk)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal,
                          window=sliding_window)
    return out.transpose(1, 2)


def decode_attention(q1, k_cache, v_cache, valid_len) -> torch.Tensor:
    """Single-query attention against a KV cache.

    q1: (B, 1, H, D); caches: (B, C, KV, D). ``valid_len`` (an int or a
    (B,) tensor) marks how many slots are populated. For sliding-window
    serving the cache is a ring buffer of size ``window`` — every populated
    slot is in-window by construction, so only validity masking is required.
    (The reference's unused ``ring``, ``window`` and ``write_pos`` keywords
    are left out.)
    """
    B, C = k_cache.shape[0], k_cache.shape[1]
    logits = _gqa_logits(q1, k_cache).to(torch.float32)   # (B,KV,G,1,C)
    slot = torch.arange(C, device=q1.device)[None, :]
    if isinstance(valid_len, torch.Tensor) and valid_len.dim() == 1:
        mask = slot < valid_len[:, None]                    # (B, C)
    else:                       # an int stays on the host: no copy, no sync
        mask = (slot < valid_len).expand(B, C)
    logits = torch.where(mask[:, None, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q1.dtype)
    return _gqa_out(probs, v_cache)


def project_qkv(p: Attention, x: torch.Tensor):
    """``x @ wq``, ``x @ wk``, ``x @ wv`` as (B, S, heads, hd), plus the
    biases where the config has them."""
    q = torch.einsum("bsd,dhx->bshx", x, p.wq)
    k = torch.einsum("bsd,dhx->bshx", x, p.wk)
    v = torch.einsum("bsd,dhx->bshx", x, p.wv)
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return q, k, v


def rotate_qk(q, k, positions, cfg: ModelConfig):
    if cfg.rope_mode == "standard":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    if cfg.rope_mode == "mrope":
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return q, k


def attention_forward(p: Attention, x: torch.Tensor, positions,
                      cfg: ModelConfig, *, causal: bool = True,
                      kv_override=None) -> torch.Tensor:
    """Projection + RoPE + attention for prefill.

    Long sequences (``S >= attn_chunk_threshold`` and a multiple of
    ``attn_chunk``) take :func:`chunked_attention`, the flash kernel; the
    rest :func:`full_attention`. ``kv_override`` supplies externally
    computed K/V (cross-attention).
    """
    S = x.shape[1]
    if kv_override is None:
        q, k, v = project_qkv(p, x)
        q, k = rotate_qk(q, k, positions, cfg)
    else:
        q = torch.einsum("bsd,dhx->bshx", x, p.wq)
        if hasattr(p, "bq"):
            q = q + p.bq
        k, v = kv_override
        # cross-attention: rotary on neither side (whisper convention)
    if S >= cfg.attn_chunk_threshold and S % cfg.attn_chunk == 0 \
            and kv_override is None:
        out = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                                sliding_window=cfg.sliding_window)
    else:
        out = full_attention(q, k, v, causal=causal,
                             sliding_window=cfg.sliding_window)
    return torch.einsum("bshx,hxd->bsd", out, p.wo)


# ----------------------------------------------------------------------- MLP
class MLP(nn.Module):
    """``w_up (d, f)``, ``w_down (f, d)`` and, for SwiGLU,
    ``w_gate (d, f)``."""

    def __init__(self, d: int, f: int, activation: str, dtype, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        shapes = {"w_up": ((d, f), d ** -0.5), "w_down": ((f, d), f ** -0.5)}
        if activation == "swiglu":
            shapes["w_gate"] = ((d, f), d ** -0.5)
        _weights(self, shapes, dtype, device, gen)


def mlp_forward(p: MLP, x: torch.Tensor, activation: str) -> torch.Tensor:
    up = x @ p.w_up
    if activation == "swiglu":
        h = F.silu(x @ p.w_gate) * up
    elif activation == "squared_relu":          # Nemotron-4 (arXiv:2402.16819)
        h = F.relu(up).square()
    elif activation == "gelu":
        h = F.gelu(up, approximate="tanh")      # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown activation {activation}")
    return h @ p.w_down


# ----------------------------------------------------------------- embeddings
class Embeddings(nn.Module):
    """``tok (vocab, d)`` and, unless tied, ``unembed (d, vocab)``."""

    def __init__(self, cfg: ModelConfig, dtype, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        v, d = cfg.vocab_size, cfg.d_model
        shapes = {"tok": ((v, d), d ** -0.5)}
        if not cfg.tie_embeddings:
            shapes["unembed"] = ((d, v), d ** -0.5)
        _weights(self, shapes, dtype, device, gen)


def embed(p: Embeddings, tokens: torch.Tensor) -> torch.Tensor:
    return p.tok[tokens]


def unembed(p: Embeddings, x: torch.Tensor) -> torch.Tensor:
    if hasattr(p, "unembed"):
        return x @ p.unembed
    return x @ p.tok.T
