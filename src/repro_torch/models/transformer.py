"""The decoder stack (port of ``repro/models/transformer.py``).

What the reference drives from one ``ModelConfig`` and the port runs:
decoders whose mixers are GQA attention (RoPE / M-RoPE / none, optional
QKV bias, sliding windows) or Mamba-2 SSM layers (:mod:`.mamba2`), and
whose feed-forward blocks are dense MLPs or MoE layers (:mod:`.moe`), in
any interleave the config gives (a Jamba-style hybrid among them); a VLM
patch-embedding prefix (``extra_embeds``); the encoder-decoder (Whisper):
an encoder over stub frame embeddings (``frames``, :func:`encode`) and
cross-attention in each decoder attention layer; the prefill ``forward``
and the single-token ``decode_step`` against a cache of K/V (a ring buffer
under a sliding window), SSM states and the encoder's cross K/V
(:func:`prepare_cross_cache`).

The reference's pytree becomes ``nn.Module``s whose parameter names are its
keys (:class:`Transformer` holds ``embed``, ``layers`` and ``final_norm``,
and for an encoder-decoder ``encoder`` and ``enc_norm``; a
:class:`DecoderLayer` holds ``norm1``, ``attn`` or ``ssm``, ``norm_cross``
and ``cross`` in an encoder-decoder's attention layers, and ``norm2`` with
``mlp`` or ``moe``). Its ``lax.scan`` over stacked layer periods (and over
the stacked encoder layers) becomes a Python loop over ``layers`` (layer
``i`` is period ``i // per``, sub-layer ``i % per``). With ``cfg.remat``
and gradients enabled, each period and each encoder layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): its
activations are recomputed in the backward pass instead of stored.

The functions keep the reference's names and signatures, with ``params`` a
:class:`Transformer`. Entry points that create tensors (``init_params``,
``init_cache``) put them on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import resolve_device
from ..parallel import P, get_parallel_context, param_placements
from ..parallel.layouts import keep_d_split, split_as_batch, write_slot
from .config import ModelConfig
from .layers import (MLP, Attention, Embeddings, RMSNorm, attention_forward,
                     decode_attention, embed, mlp_forward, project_qkv,
                     rmsnorm, rotate_qk, torch_dtype, unembed)
from .mamba2 import (Mamba2, mamba2_decode_step, mamba2_forward,
                     mamba2_init_cache)
from .moe import MoE, moe_forward


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
    ``cfg.layer_kind(i)``; in an encoder-decoder's attention layer,
    ``norm_cross`` and ``cross``; then ``norm2`` and ``moe`` where
    ``cfg.layer_is_moe(i)``, else ``mlp`` where ``cfg.d_ff > 0``
    (reference ``transformer.py:58-75``)."""

    def __init__(self, cfg: ModelConfig, i: int, dtype, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        if cfg.layer_kind(i) == "attn":
            self.attn = Attention(cfg, dtype, device, gen)
            if cfg.is_encoder_decoder:
                self.norm_cross = RMSNorm(cfg.d_model, device=device)
                self.cross = Attention(cfg, dtype, device, gen)
        else:
            self.ssm = Mamba2(cfg, dtype, device, gen)
        if cfg.layer_is_moe(i):
            self.norm2 = RMSNorm(cfg.d_model, device=device)
            self.moe = MoE(cfg, dtype, device, gen)
        elif cfg.d_ff > 0:
            self.norm2 = RMSNorm(cfg.d_model, device=device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, dtype,
                           device, gen)


class EncoderLayer(nn.Module):
    """Encoder layer, pre-norm: ``norm1``, ``attn``, ``norm2`` and ``mlp``
    of width ``d_ff or 4 * d_model`` (reference ``transformer.py:78-86``).
    """

    def __init__(self, cfg: ModelConfig, dtype, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, dtype, device, gen)
        self.norm2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff or 4 * cfg.d_model,
                       cfg.activation, dtype, device, gen)


class Transformer(nn.Module):
    """The model's parameters: ``embed`` (``tok``, ``unembed`` unless
    tied), ``layers`` (``num_layers`` :class:`DecoderLayer`s),
    ``final_norm`` and, for an encoder-decoder, ``encoder``
    (``encoder_layers`` :class:`EncoderLayer`s) and ``enc_norm``. With
    ``gen`` the weights are drawn as ``init_params`` draws them; without,
    they are left uninitialised for a loader to fill. ``cfg`` is kept: the
    checkpointer reads the reference's layout from it.
    """

    def __init__(self, cfg: ModelConfig, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.embed = Embeddings(cfg, dtype, device, gen)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, dtype, device, gen)
                                    for i in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, device=device)
        if cfg.is_encoder_decoder:
            self.encoder = nn.ModuleList(
                EncoderLayer(cfg, dtype, device, gen)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = RMSNorm(cfg.d_model, device=device)


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


def _decoder_sublayer(p: DecoderLayer, x, positions, cfg: ModelConfig,
                      enc_out=None, cache_kv=None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    if hasattr(p, "attn"):
        # the output feeds the cross-attention's query, which contracts it
        # split: its d keeps the model axis's share (a layout hook)
        with keep_d_split() if enc_out is not None \
                and hasattr(p, "cross") else contextlib.nullcontext():
            x = x + attention_forward(p.attn, h, positions, cfg, causal=True,
                                      cache_kv=cache_kv)
    else:
        x = x + mamba2_forward(p.ssm, h, cfg)
    del h       # not held through the next norm, as XLA reuses its buffer
    if enc_out is not None and hasattr(p, "cross"):
        hc = rmsnorm(p.norm_cross, x, cfg.norm_eps)
        ck = torch.einsum("bsd,dhx->bshx", enc_out, p.cross.wk)
        cv = torch.einsum("bsd,dhx->bshx", enc_out, p.cross.wv)
        x = x + attention_forward(p.cross, hc, positions, cfg, causal=False,
                                  kv_override=(ck, cv))
    return _feed_forward(p, x, cfg)


def _activation_constraint(x: torch.Tensor) -> torch.Tensor:
    """Pin (B, S, d) activations to batch-over-data sharding, and with
    ``sequence_parallel`` the sequence over the model axis where it divides
    (reference ``transformer.py:146-158``, a GSPMD sharding constraint).
    Only a DTensor is laid out over devices: it is redistributed to that
    layout under a context with ``constrain_activations``; any other tensor
    (one rank's own rows) is returned as it is. It applies at the start of
    each layer period and encoder layer, as the reference's, but outside
    their checkpoint: the input that remat keeps has the pinned layout, as
    the reference's scan carry has it."""
    ctx = get_parallel_context()
    if ctx is None or not ctx.constrain_activations or x.ndim != 3 \
            or not isinstance(x, DTensor):
        return x
    seq = None
    if ctx.sequence_parallel and x.shape[1] % ctx.tp_size == 0:
        seq = ctx.model_axis
    return x.redistribute(ctx.mesh, param_placements(
        P(ctx.data_spec, seq, None), ctx.mesh))


def _period_body(period: nn.ModuleList, x, aux, positions,
                 cfg: ModelConfig, enc_out=None, caches=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    for j, layer in enumerate(period):
        x, a = _decoder_sublayer(layer, x, positions, cfg, enc_out,
                                 None if caches is None else caches[j])
        if a is not None:           # the reference adds a zero for the rest
            aux = aux + a
    return x, aux


def _sinusoidal(S: int, d: int, device=None) -> torch.Tensor:
    """(S, d) float32 sinusoidal positions: sines, then cosines."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _encoder_layer(p: EncoderLayer, h, ecfg: ModelConfig) -> torch.Tensor:
    a = rmsnorm(p.norm1, h, ecfg.norm_eps)
    h = h + attention_forward(p.attn, a, None, ecfg, causal=False)
    m = rmsnorm(p.norm2, h, ecfg.norm_eps)
    return h + mlp_forward(p.mlp, m, ecfg.activation)


def encode(params: Transformer, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """Whisper-style encoder over stub conv-frontend frames (B, T, d):
    sinusoidal positions added, non-causal attention without rotary or
    window, then ``enc_norm``."""
    x = frames + _sinusoidal(frames.shape[1], cfg.d_model,
                             frames.device).to(frames.dtype)
    ecfg = cfg.with_(rope_mode="none", sliding_window=0)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in params.encoder:
        x = _activation_constraint(x)
        if remat:
            x = checkpoint(_encoder_layer, p, x, ecfg, use_reentrant=False)
        else:
            x = _encoder_layer(p, x, ecfg)
    return rmsnorm(params.enc_norm, x, cfg.norm_eps)


def fills_cache(cfg: ModelConfig) -> bool:
    """Whether :func:`forward` can fill a decode cache for ``cfg`` as
    decode steps would: a decoder of attention layers with no MoE block (no
    SSM state or cross K/V to write, and no capacity to drop slots that a
    decode step, routing one token, keeps)."""
    return not cfg.is_encoder_decoder and not any(
        cfg.layer_kind(i) != "attn" or cfg.layer_is_moe(i)
        for i in range(cfg.num_layers))


def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
            positions=None, extra_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            cache: Optional[Dict[str, Any]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward.

    tokens: (B, S) int. ``extra_embeds`` (VLM): (B, P, d) patch embeddings
    prepended to the token embeddings. ``frames`` (audio): (B, T, d) stub
    frame embeddings consumed by the encoder.
    Returns (logits (B, S_total, vocab), moe_aux_loss): the float32 sum of
    the MoE layers' load-balancing losses (zero without MoE layers).

    With ``cache`` (an empty :func:`init_cache` of a config that
    :func:`fills_cache` accepts), each layer's rotated K and V are also
    written into it, each position at the slot its decode step would write,
    and ``cache["pos"]`` becomes ``S_total``: decoding goes on from the
    prompt as after ``S_total`` decode steps. The reference has no such
    prefill (its engine steps the prompt a token at a time).
    """
    if cache is not None and (cache["pos"] != 0 or not fills_cache(cfg)):
        raise ValueError("a prefill fills an empty cache of attention "
                         "layers only (no SSM state, no cross K/V, no "
                         "MoE block)")
    B, S = tokens.shape
    x = embed(params.embed, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        S = x.shape[1]
    if positions is None:
        # laid out as the batch is (a layout hook)
        positions = split_as_batch(
            _default_positions(cfg, B, S, device=x.device), x)
    enc_out = None
    if cfg.is_encoder_decoder:
        if frames is None:
            raise ValueError("encoder-decoder model needs `frames`")
        enc_out = encode(params, frames, cfg)
    per = layer_period(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, cfg.num_layers, per):
        period = params.layers[i:i + per]
        caches = None if cache is None else cache["layers"][i:i + per]
        x = _activation_constraint(x)
        if remat:
            x, aux = checkpoint(_period_body, period, x, aux, positions, cfg,
                                enc_out, caches, use_reentrant=False)
        else:
            x, aux = _period_body(period, x, aux, positions, cfg, enc_out,
                                  caches)
    if cache is not None:
        cache["pos"] = S
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
    (float32, :func:`~.mamba2.mamba2_init_cache`) for an SSM layer; for an
    encoder-decoder also ``"cross"``, one ``{"k", "v"}`` of ``(batch,
    encoder_seq, KV, hd)`` a layer. ``pos`` is a host int. ``device=None``
    means CUDA."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    C = cache_len(cfg, max_len)
    shape = (batch, C, cfg.num_kv_heads, cfg.resolved_head_dim)
    layers = [{"k": torch.zeros(shape, dtype=dt, device=dev),
               "v": torch.zeros(shape, dtype=dt, device=dev)}
              if cfg.layer_kind(i) == "attn"
              else mamba2_init_cache(cfg, batch, device=dev)
              for i in range(cfg.num_layers)]
    cache: Dict[str, Any] = {"pos": 0, "layers": layers}
    if cfg.is_encoder_decoder:
        cross = (batch, cfg.encoder_seq) + shape[2:]
        cache["cross"] = [{"k": torch.zeros(cross, dtype=dt, device=dev),
                           "v": torch.zeros(cross, dtype=dt, device=dev)}
                          for _ in range(cfg.num_layers)]
    return cache


def prepare_cross_cache(params: Transformer, frames: torch.Tensor,
                        cfg: ModelConfig) -> List[Dict[str, torch.Tensor]]:
    """Whisper: run the encoder once and project each decoder layer's cross
    K/V, ``(B, T, KV, hd)`` in the encoder's dtype, one ``{"k", "v"}`` a
    layer (``init_cache``'s ``"cross"``)."""
    assert layer_period(cfg) == 1, "enc-dec archs use homogeneous stacks"
    enc = encode(params, frames, cfg)
    return [{"k": torch.einsum("bsd,dhx->bshx", enc, p.cross.wk).to(enc.dtype),
             "v": torch.einsum("bsd,dhx->bshx", enc, p.cross.wv).to(enc.dtype)}
            for p in params.layers]


def _attn_decode_sublayer(p: DecoderLayer, x1, pos: int,
                          cache_kv: Dict[str, torch.Tensor],
                          cfg: ModelConfig, cross_kv=None) -> torch.Tensor:
    """x1: (B, 1, d); cache_kv: {'k': (B, C, KV, hd), 'v': ...}, written in
    place at this step's slot; cross_kv: the layer's cross K/V, (B, T, KV,
    hd), or ``None``. The cross query takes no bias, as in the reference's
    decode (its prefill adds one)."""
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
    write_slot(cache_kv["k"], write, k1)
    write_slot(cache_kv["v"], write, v1)
    att = decode_attention(q, cache_kv["k"], cache_kv["v"], min(pos + 1, C))
    x1 = x1 + torch.einsum("bshx,hxd->bsd", att, p.attn.wo)
    if cross_kv is not None and hasattr(p, "cross"):
        hc = rmsnorm(p.norm_cross, x1, cfg.norm_eps)
        qc = torch.einsum("bsd,dhx->bshx", hc, p.cross.wq)
        catt = decode_attention(qc, cross_kv["k"], cross_kv["v"],
                                cross_kv["k"].shape[1])
        x1 = x1 + torch.einsum("bshx,hxd->bsd", catt, p.cross.wo)
    return x1


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
    pos = int(cache["pos"])
    x = embed(params.embed, tokens1)
    cross = cache.get("cross") or [None] * len(params.layers)
    for p, c, ckv in zip(params.layers, cache["layers"], cross):
        if hasattr(p, "attn"):
            # an encoder-decoder's step keeps d split over the model axis
            # through both attentions (a layout hook)
            with keep_d_split() if ckv is not None \
                    else contextlib.nullcontext():
                x = _attn_decode_sublayer(p, x, pos, c, cfg, ckv)
        else:
            h = rmsnorm(p.norm1, x, cfg.norm_eps)
            x = x + mamba2_decode_step(p.ssm, h, c, cfg)[0]
        x, _ = _feed_forward(p, x, cfg)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return unembed(params.embed, x), cache
