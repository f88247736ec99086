"""The decoder stack (port of ``repro/models/transformer.py``).

What the reference drives from one ``ModelConfig`` and the port runs:
decoders whose mixers are GQA attention (RoPE / M-RoPE / none, optional
QKV bias, sliding windows) or Mamba-2 SSM layers (:mod:`.mamba2`), and
whose feed-forward blocks are dense MLPs or MoE layers (:mod:`.moe`), in
any interleave the config gives (a Jamba-style hybrid among them); a VLM
patch-embedding prefix (``extra_embeds``), the prefill ``forward`` and the
single-token ``decode_step`` against a cache of K/V (a ring buffer under a
sliding window) and SSM states. The encoder-decoder models raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.

The reference's pytree becomes ``nn.Module``s whose parameter names are its
keys (:class:`Transformer` holds ``embed``, ``layers`` and ``final_norm``; a
:class:`DecoderLayer` holds ``norm1``, ``attn`` or ``ssm``, and ``norm2``
with ``mlp`` or ``moe``). Its ``lax.scan`` over stacked layer periods
becomes a Python loop over ``layers`` (layer ``i`` is period ``i // per``,
sub-layer ``i % per``). With ``cfg.remat`` and gradients enabled, each
period runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint(period_body)``): its activations are recomputed in the
backward pass instead of stored.

The functions keep the reference's names and signatures, with ``params`` a
:class:`Transformer`. Entry points that create tensors (``init_params``,
``init_cache``) put them on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import resolve_device
from .config import ModelConfig
from .layers import (MLP, Attention, Embeddings, RMSNorm, attention_forward,
                     decode_attention, embed, mlp_forward, project_qkv,
                     rmsnorm, rotate_qk, torch_dtype, unembed)
from .mamba2 import (Mamba2, mamba2_decode_step, mamba2_forward,
                     mamba2_init_cache)
from .moe import MoE, moe_forward


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the part of the zoo the port does not run yet."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder and cross-attention are not ported yet "
            f"(ROADMAP.md queue 1, item 10: encoder-decoder)")


# --------------------------------------------------------------------- period
def layer_period(cfg: ModelConfig) -> int:
    """Smallest repeating pattern of (mixer kind, moe-ness) over layers."""
    per = 1
    if cfg.arch_type == "hybrid" and cfg.attn_every > 0:
        per = cfg.attn_every
    if cfg.moe_experts > 0 and cfg.moe_every > 1:
        per = _lcm(per, cfg.moe_every)
    if cfg.num_layers % per != 0:
        raise ValueError(f"{cfg.name}: num_layers={cfg.num_layers} not divisible "
                         f"by layer period {per}")
    return per


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


# -------------------------------------------------------------------- modules
class DecoderLayer(nn.Module):
    """Decoder layer ``i``, pre-norm: ``norm1`` and ``attn`` or ``ssm`` by
    ``cfg.layer_kind(i)``; then ``norm2`` and ``moe`` where
    ``cfg.layer_is_moe(i)``, else ``mlp`` where ``cfg.d_ff > 0``
    (reference ``transformer.py:58-75``)."""

    def __init__(self, cfg: ModelConfig, i: int, dtype, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        if cfg.layer_kind(i) == "attn":
            self.attn = Attention(cfg, dtype, device, gen)
        else:
            self.ssm = Mamba2(cfg, dtype, device, gen)
        if cfg.layer_is_moe(i):
            self.norm2 = RMSNorm(cfg.d_model, device=device)
            self.moe = MoE(cfg, dtype, device, gen)
        elif cfg.d_ff > 0:
            self.norm2 = RMSNorm(cfg.d_model, device=device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, dtype,
                           device, gen)


class Transformer(nn.Module):
    """The decoder's parameters: ``embed`` (``tok``, ``unembed`` unless
    tied), ``layers`` (``num_layers`` :class:`DecoderLayer`s) and
    ``final_norm``. With ``gen`` the weights are drawn as ``init_params``
    draws them; without, they are left uninitialised for a loader to fill.
    ``cfg`` is kept: the checkpointer reads the reference's layout from it.
    """

    def __init__(self, cfg: ModelConfig, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.embed = Embeddings(cfg, dtype, device, gen)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, dtype, device, gen)
                                    for i in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, device=device)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """Random weights with the reference's distributions and scales
    (``layers.py:80-94, 248-280``, ``moe.py:39-50``, ``mamba2.py:25-44``,
    ``transformer.py:58-109``): normal draws in float32 times
    ``fan_in ** -0.5``, cast to ``cfg.dtype`` (the MoE router stays
    float32); zero QKV and conv biases; float32 RMSNorm scales and the
    SSM's float32 constants. ``generator`` lives on
    ``device`` (``None`` means CUDA). The values are not JAX's bits."""
    return Transformer(cfg, device=resolve_device(device), gen=generator)


# ------------------------------------------------------------------- forward
def _default_positions(cfg: ModelConfig, B: int, S: int,
                       device=None) -> torch.Tensor:
    pos = torch.arange(S, dtype=torch.int32, device=device)
    pos = pos[None, :].expand(B, S)
    if cfg.rope_mode == "mrope":
        return pos[..., None].expand(B, S, 3)  # text: t==h==w
    return pos


def _feed_forward(p: DecoderLayer, x, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``x`` plus the layer's MoE or MLP block, and the MoE's aux loss
    (``None`` for an MLP or no block)."""
    if hasattr(p, "moe"):
        y, aux = moe_forward(p.moe, rmsnorm(p.norm2, x, cfg.norm_eps), cfg)
        return x + y, aux
    if hasattr(p, "mlp"):
        h2 = rmsnorm(p.norm2, x, cfg.norm_eps)
        x = x + mlp_forward(p.mlp, h2, cfg.activation)
    return x, None


def _decoder_sublayer(p: DecoderLayer, x, positions, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    if hasattr(p, "attn"):
        x = x + attention_forward(p.attn, h, positions, cfg, causal=True)
    else:
        x = x + mamba2_forward(p.ssm, h, cfg)
    return _feed_forward(p, x, cfg)


def _period_body(period: nn.ModuleList, x, aux, positions,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    for layer in period:
        x, a = _decoder_sublayer(layer, x, positions, cfg)
        if a is not None:           # the reference adds a zero for the rest
            aux = aux + a
    return x, aux


def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
            positions=None, extra_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward.

    tokens: (B, S) int. ``extra_embeds`` (VLM): (B, P, d) patch embeddings
    prepended to the token embeddings. ``frames`` belong to the
    encoder-decoder models, not ported yet.
    Returns (logits (B, S_total, vocab), moe_aux_loss): the float32 sum of
    the MoE layers' load-balancing losses (zero without MoE layers).
    """
    check_supported(cfg)
    if frames is not None:
        raise NotImplementedError("frames feed the encoder, not ported yet "
                                  "(ROADMAP.md queue 1, item 10)")
    B, S = tokens.shape
    x = embed(params.embed, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        S = x.shape[1]
    if positions is None:
        positions = _default_positions(cfg, B, S, device=x.device)
    # The reference pins activations to batch-over-data sharding at each
    # layer period (``_activation_constraint``); one card has no sharding.
    # Sharded execution is ROADMAP.md queue 1, item 12 (parallel).
    per = layer_period(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, cfg.num_layers, per):
        period = params.layers[i:i + per]
        if remat:
            x, aux = checkpoint(_period_body, period, x, aux, positions, cfg,
                                use_reentrant=False)
        else:
            x, aux = _period_body(period, x, aux, positions, cfg)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.embed, x), aux


# --------------------------------------------------------------------- cache
def cache_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window > 0:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict[str, Any]:
    """Decode cache of zeros: ``{"pos": 0, "layers": [...]}``, one entry a
    layer (the reference stacks them by layer period): ``{"k", "v"}`` of
    ``(batch, C, KV, hd)`` for an attention layer, ``{"state", "conv"}``
    (float32, :func:`~.mamba2.mamba2_init_cache`) for an SSM layer. ``pos``
    is a host int. ``device=None`` means CUDA."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    C = cache_len(cfg, max_len)
    shape = (batch, C, cfg.num_kv_heads, cfg.resolved_head_dim)
    layers = [{"k": torch.zeros(shape, dtype=dt, device=dev),
               "v": torch.zeros(shape, dtype=dt, device=dev)}
              if cfg.layer_kind(i) == "attn"
              else mamba2_init_cache(cfg, batch, device=dev)
              for i in range(cfg.num_layers)]
    return {"pos": 0, "layers": layers}


def prepare_cross_cache(params: Transformer, frames: torch.Tensor,
                        cfg: ModelConfig):
    """Whisper's encoder pass and cross K/V: not ported yet."""
    raise NotImplementedError("the encoder and cross-attention are not "
                              "ported yet (ROADMAP.md queue 1, item 10)")


def _attn_decode_sublayer(p: DecoderLayer, x1, pos: int,
                          cache_kv: Dict[str, torch.Tensor],
                          cfg: ModelConfig) -> torch.Tensor:
    """x1: (B, 1, d); cache_kv: {'k': (B, C, KV, hd), 'v': ...}, written in
    place at this step's slot."""
    B = x1.shape[0]
    C = cache_kv["k"].shape[1]
    h = rmsnorm(p.norm1, x1, cfg.norm_eps)
    q, k1, v1 = project_qkv(p.attn, h)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x1.device)
    if cfg.rope_mode == "mrope":
        posb = posb[..., None].expand(B, 1, 3)
    q, k1 = rotate_qk(q, k1, posb, cfg)
    write = pos % C if cfg.sliding_window > 0 else pos
    if write >= C:
        raise ValueError(f"decode position {pos} is past the cache's {C} "
                         f"slots (max_len)")
    cache_kv["k"][:, write] = k1[:, 0]
    cache_kv["v"][:, write] = v1[:, 0]
    att = decode_attention(q, cache_kv["k"], cache_kv["v"], min(pos + 1, C))
    return x1 + torch.einsum("bshx,hxd->bsd", att, p.attn.wo)


def decode_step(params: Transformer, cache: Dict[str, Any],
                tokens1: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. tokens1: (B, 1) -> logits (B, 1, vocab), cache.

    Unlike the reference, which returns a new cache pytree, this writes the
    step's k and v, or SSM state and conv window, into the cache's tensors
    in place (no copy of the cache per token) and advances
    ``cache["pos"]``: the cache passed in is the one returned. An MoE layer
    routes the step's B tokens with the capacity of B tokens, as the
    reference's does.
    """
    check_supported(cfg)
    pos = int(cache["pos"])
    x = embed(params.embed, tokens1)
    for p, c in zip(params.layers, cache["layers"]):
        if hasattr(p, "attn"):
            x = _attn_decode_sublayer(p, x, pos, c, cfg)
        else:
            h = rmsnorm(p.norm1, x, cfg.norm_eps)
            x = x + mamba2_decode_step(p.ssm, h, c, cfg)[0]
        x, _ = _feed_forward(p, x, cfg)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return unembed(params.embed, x), cache
