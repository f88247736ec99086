"""Mixture-of-Experts layer (port of ``repro/models/moe.py``): shared and
routed experts, top-k routing with a fixed capacity, sort-and-scatter
dispatch (no O(tokens^2) one-hot products).

Routing follows DeepSeekMoE / Qwen2-MoE: float32 router logits, softmax,
top-k, renormalised weights, and a Switch-style load-balancing auxiliary
loss. Three forms, chosen by ``cfg.moe_impl`` and the installed
:class:`~repro_torch.parallel.ParallelContext` as the reference chooses
(:func:`moe_forward`):

* ``dense`` — one rank dispatches to every expert. Under a context with
  more than one data rank (outside the explicit grad-sync modes) it routes
  the whole data group's tokens, as the reference's one GSPMD program over
  the global batch does: capacity, drops and the aux loss are global.
* ``ep`` (:func:`_moe_ep_psum`) — tokens replicated over the model group;
  model rank ``m`` serves experts ``[m * E/tp, (m + 1) * E/tp)`` and the
  partial outputs are summed over the group.
* ``ep_a2a`` (:func:`_moe_ep_a2a`) — each model rank routes its chunk of
  the sequence, and two all-to-alls carry the tokens to the expert owners
  and back.

Where the port differs in form, and why:

* The reference scatters tokens into the capacity buffer with
  ``mode="drop"``, which discards writes past the capacity. PyTorch has no
  such mode, so a dropped slot is written to one spare row past the buffer,
  which is then cut off.
* The reference combines with a scatter-add over tokens. On the card
  ``index_add_`` adds with atomics, whose order (and so the bf16 bits)
  changes from run to run; the port un-permutes the slots to (N, k, d) and
  sums over k instead, the same bits every run. Each dispatch (into the
  capacity buffer, and ``ep_a2a``'s into its send buffer) copies the
  tokens once a choice, for the same reason: its gradient
  then sums a token's k rows in order, with no atomics, so two ranks that
  run the same step hold the same bits.
* The reference's expert-parallel forms run inside ``shard_map``; here
  their bodies (:func:`_ep_psum_local`, :func:`_ep_a2a_local`) run inside
  :func:`~repro_torch.parallel.regions.shard_map` at the same specs. On
  DTensors (the dry run) each rank gets its experts' block of the weights;
  on plain tensors every rank holds the whole (replicated) weights and the
  boundary slices its experts out, the collectives being the
  autograd-aware ones of :mod:`repro_torch.parallel.regions`, so every rank
  ends the backward pass with the whole gradient of every weight, the same
  bits on every model rank.
* On DTensors the dense path runs on the global batch, as the reference's
  one GSPMD program, with the reference's ``_constrain`` of the capacity
  buffer and the experts' outputs (:func:`_constrain`); where the model
  axis divides neither E nor C, the layout GSPMD takes from the experts'
  weights instead (:func:`_buffer_placements`: d split as they split it).
  Its zeros are made from the tokens (``new_zeros``), so that on a DTensor
  they carry its layout.

No step syncs with the host: the kept and dropped slots are masks on the
device, and the experts' loads are a scatter-add, not ``bincount`` (which
reads its output's size from the card).
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..parallel import P, get_parallel_context, param_placements
from ..parallel.layouts import redistribute_over_data
from ..parallel.regions import (all_to_all, exchange, gather_rows,
                                mean_over, reduce_from, shard_map)
from .config import ModelConfig
from .layers import MLP, _weights, mlp_forward


class MoE(nn.Module):
    """``router`` (float32, (d, E)), ``w_up`` / ``w_gate`` ((E, d, f)),
    ``w_down`` ((E, f, d)) and, when ``cfg.d_ff > 0``, ``shared``: the
    shared experts fused into one SwiGLU :class:`MLP` of width ``d_ff``
    (``init_moe``, ``moe.py:39-50``)."""

    def __init__(self, cfg: ModelConfig, dtype, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
        _weights(self, {"router": ((d, e), d ** -0.5)}, torch.float32,
                 device, gen)
        _weights(self, {"w_up": ((e, d, f), d ** -0.5),
                        "w_gate": ((e, d, f), d ** -0.5),
                        "w_down": ((e, f, d), f ** -0.5)}, dtype, device, gen)
        if cfg.d_ff > 0:
            self.shared = MLP(d, cfg.d_ff, "swiglu", dtype, device, gen)


def _route(p: MoE, x2d: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (weights (N, k), expert ids (N, k), aux loss scalar). The
    router product is float32 (TF32 would flip near-tied choices)."""
    logits = x2d.to(torch.float32) @ p.router                     # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.moe_top_k, dim=-1)       # (N, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e fraction_e * prob_e
    e = cfg.moe_experts
    flat = top_e.reshape(-1)
    # a count a slot (exact in float32); bincount would sync with the host
    frac = flat.new_zeros((e,), dtype=torch.float32).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.float32))
    frac = frac / top_e.numel()
    pmean = probs.mean(dim=0)
    aux = e * torch.sum(frac * pmean)
    return top_w, top_e, aux


def _positions(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Stable sort of ``keys``: (order, sorted keys, each one's rank among
    its equals). The sort is stable and the search takes the left end, as
    ``jnp.argsort`` / ``jnp.searchsorted`` do, so the same slots come first
    in each group and the same ones drop at capacity."""
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    first = torch.searchsorted(sk, sk, side="left")
    return order, sk, torch.arange(sk.shape[0], device=keys.device) - first


def _dispatch_indices(top_e: torch.Tensor, k: int, num_experts: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort slots by expert; return (sorted expert id, position-in-expert,
    source slot order)."""
    order, sorted_e, pos_in_e = _positions(top_e.reshape(-1))   # (N*k,)
    return sorted_e, pos_in_e, order


def _expert_ffn(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d) through each expert's SwiGLU FFN."""
    up = _reduced(torch.einsum("ecd,edf->ecf", buf, p.w_up))
    gate = _reduced(torch.einsum("ecd,edf->ecf", buf, p.w_gate))
    h = F.silu(gate) * up
    return torch.einsum("ecf,efd->ecd", h, p.w_down)


def _reduced(t: torch.Tensor) -> torch.Tensor:
    """On a DTensor, ``t`` with its partial sums reduced whole (the experts'
    products against a buffer split along d, their contraction: GSPMD's
    all-reduce before the activation, where DTensor would scatter the sum
    over E). Any other tensor is returned as it is."""
    if not isinstance(t, DTensor) or not any(p.is_partial()
                                             for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.moe_top_k * cfg.moe_capacity_factor
            / cfg.moe_experts) + 1
    # padded to a multiple of 8 as the reference pads (for TPU layouts):
    # the same capacity keeps the same slots
    return max(8, -(-c // 8) * 8)


def _pack(x2d: torch.Tensor, dest: torch.Tensor, order: torch.Tensor,
          k: int, rows: int) -> torch.Tensor:
    """A (rows, d) zero buffer with slot ``order[i]`` (token ``order[i] //
    k``'s choice ``order[i] % k``) copied to row ``dest[i]``. One copy of
    the tokens a choice, so the backward sums a token's k rows in order,
    where the gradient of ``x2d.index_select(0, order // k)`` would add
    them with atomics."""
    n, d = x2d.shape
    buf = x2d.new_zeros((rows, d))
    by_token = torch.empty_like(dest).index_copy_(0, order, dest).view(n, k)
    for j in range(k):
        buf.index_copy_(0, by_token[:, j], x2d)
    return buf


def _experts(ex, x2d, top_w, sorted_e, pos_in_e, order, ok, lo: int,
             e_loc: int, cap: int, k: int) -> torch.Tensor:
    """The slots where ``ok`` through experts ``[lo, lo + e_loc)`` of
    ``ex``: scattered into an (e_loc, cap, d) buffer at their positions,
    each expert's FFN, and gathered back weighted; the other slots give 0.
    Returns (N, d): each token's slots summed over k."""
    n, d = x2d.shape
    le = sorted_e - lo
    rows = x2d
    x2d = _by_features(x2d, ex.w_up, e_loc, cap)
    # rows of the flattened (e_loc * cap + 1, d) buffer; a slot not kept
    # lands in the last row, cut off below
    dest = torch.where(ok, le * cap + pos_in_e, e_loc * cap)
    buf = _pack(x2d, dest, order, k, e_loc * cap + 1)
    out = _constrain(_expert_ffn(ex, _constrain(
        buf[:e_loc * cap].view(e_loc, cap, d), ex.w_up)), ex.w_up)
    vals = out.reshape(e_loc * cap, d).index_select(
        0, torch.clamp(le, 0, e_loc - 1) * cap
        + torch.clamp(pos_in_e, max=cap - 1))
    vals = torch.where(ok[:, None], vals, 0.0)
    w_sorted = top_w.reshape(-1)[order].to(vals.dtype)
    # un-permute to (N, k, d) and sum over k: no atomics, the same bits
    slots = torch.empty_like(vals).index_copy_(0, order,
                                               vals * w_sorted[:, None])
    y = slots.view(n, k, d).sum(dim=1)
    return y.redistribute(rows.device_mesh, rows.placements) \
        if x2d is not rows else y


def _buffer_placements(ctx, mesh, shape, w_up) -> Optional[list]:
    """The placements of the dense path's (E, C, d) capacity buffer (and
    the experts' output) on a DTensor, as the reference lays it out: its
    ``_constrain`` (``moe.py:110-125``, a GSPMD sharding constraint) splits
    it over the model axis along E where that divides, else along C, whole
    over the data axes; where neither divides (qwen2-moe's 60 experts and
    capacity 87384 on a 16-way axis) the constraint is the identity and
    GSPMD takes the layout from the experts' weights: d split as ``w_up``
    splits its d (FSDP, over the data axes), E and C whole."""
    m, tp = ctx.model_axis, ctx.tp_size
    if shape[0] % tp == 0:
        return param_placements(P(m, None, None), mesh)
    if shape[1] % tp == 0:
        return param_placements(P(None, m, None), mesh)
    if not isinstance(w_up, DTensor) or w_up.device_mesh != mesh:
        return None
    return [Shard(2) if p.is_shard(1) else Replicate()
            for p in w_up.placements]


def _constrain(t: torch.Tensor, w_up) -> torch.Tensor:
    """``t`` (the capacity buffer or the experts' output) laid out by
    :func:`_buffer_placements`. A plain tensor (one rank's own) is returned
    as it is."""
    ctx = get_parallel_context()
    if ctx is None or not isinstance(t, DTensor):
        return t
    placements = _buffer_placements(ctx, t.device_mesh, t.shape, w_up)
    return t if placements is None \
        else t.redistribute(t.device_mesh, placements)


def _by_features(x2d: torch.Tensor, w_up, e_loc: int, cap: int
                 ) -> torch.Tensor:
    """The tokens the capacity buffer is packed from, on a DTensor whose
    buffer :func:`_buffer_placements` splits along d: every row, with d
    split as the buffer's, so that the buffer is born in its layout
    (GSPMD's, where the reference's constraint leaves it to the weights).
    Any other tensor is returned as it is."""
    ctx = get_parallel_context()
    if ctx is None or not isinstance(x2d, DTensor):
        return x2d
    mesh = x2d.device_mesh
    placements = _buffer_placements(ctx, mesh, (e_loc, cap), w_up)
    if placements is None or not any(p.is_shard(2) for p in placements):
        return x2d
    return redistribute_over_data(x2d, [Shard(1) if p.is_shard(2)
                                        else Replicate() for p in placements])


def _moe_dense(p: MoE, x2d: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    n, d = x2d.shape
    k, e = cfg.moe_top_k, cfg.moe_experts
    top_w, top_e, aux = _route(p, x2d, cfg)
    sorted_e, pos_in_e, order = _dispatch_indices(top_e, k, e)
    cap = _capacity(n, cfg)
    keep = pos_in_e < cap
    return _experts(p, x2d, top_w, sorted_e, pos_in_e, order, keep, 0, e,
                    cap, k), aux


def _ep_specs(ctx, x: torch.Tensor, seq: bool):
    """The reference's ``shard_map`` specs of the expert-parallel forms:
    the router whole, the experts split over the model axis, the tokens
    over the data axes (the batch whole where it does not split over them,
    as ``long_500k``'s one sequence) and, with ``seq``, the sequence over
    the model axis; in (router, w_up, w_gate, w_down, x), out (y, aux)."""
    m = ctx.model_axis
    dp = ctx.data_spec if x.shape[0] % ctx.dp_size == 0 else None
    tokens = P(dp, m if seq else None, None)
    experts = P(m, None, None)
    return (P(), experts, experts, experts, tokens), (tokens, P())


def _moe_ep_psum(p: MoE, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel path: local-expert dispatch + psum combine (the
    reference's ``_moe_ep_shardmap``), :func:`_ep_psum_local` inside the
    :func:`shard_map` boundary."""
    ins, outs = _ep_specs(get_parallel_context(), x, seq=False)
    return shard_map(functools.partial(_ep_psum_local, cfg=cfg), ins, outs)(
        p.router, p.w_up, p.w_gate, p.w_down, x)


def _ep_psum_local(router, w_up, w_gate, w_down, x, *, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One model rank's part of ``ep``, on its local tensors.

    Tokens are replicated along the model group; each rank serves only its
    E/tp local experts (``w_*``, this rank's block) at the capacity of all
    its tokens and contributes a partial output, summed over the group —
    the direct analogue of Canary's in-fabric partial aggregation. The aux
    loss is the group's mean.
    """
    ctx = get_parallel_context()
    g = ctx.model_group
    e, k = cfg.moe_experts, cfg.moe_top_k
    e_loc = w_up.shape[0]
    lo = ctx.model_rank * e_loc
    B, S, d = x.shape
    n = B * S
    x2d = x.reshape(n, d)
    top_w, top_e, aux = _route(SimpleNamespace(router=router), x2d, cfg)
    sorted_e, pos_in_e, order = _dispatch_indices(top_e, k, e)
    cap = _capacity(n, cfg)
    local_ok = (sorted_e >= lo) & (sorted_e < lo + e_loc) & (pos_in_e < cap)
    ex = SimpleNamespace(w_up=w_up, w_gate=w_gate, w_down=w_down)
    y = _experts(ex, x2d, top_w, sorted_e, pos_in_e, order, local_ok, lo,
                 e_loc, cap, k)
    y = reduce_from(y, g)                    # combine expert partials
    return y.view(B, S, d), mean_over(aux, g)


def _moe_ep_a2a(p: MoE, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-to-all expert parallelism (the reference's
    ``_moe_ep_a2a_shardmap``), :func:`_ep_a2a_local` inside the
    :func:`shard_map` boundary, the sequence split over the model axis."""
    ins, outs = _ep_specs(get_parallel_context(), x, seq=True)
    return shard_map(functools.partial(_ep_a2a_local, cfg=cfg), ins, outs)(
        p.router, p.w_up, p.w_gate, p.w_down, x)


def _ep_a2a_local(router, w_up, w_gate, w_down, x, *, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One model rank's part of ``ep_a2a``, on its local tensors: ``x`` is
    its chunk of the sequence.

    The rank routes its own tokens, packs them by destination rank, and
    two all-to-alls carry them to the expert owners and back; the owner
    dispatches what it received to its local experts at a second capacity.
    Per-rank link bytes are ~2k/tp of the token stream against ~2x for the
    psum combine. The aux loss is the mean of the chunks'.
    """
    ctx = get_parallel_context()
    g, tp, m = ctx.model_group, ctx.tp_size, ctx.model_rank
    e, k, cf = cfg.moe_experts, cfg.moe_top_k, cfg.moe_capacity_factor
    e_loc = w_up.shape[0]
    B, s_loc, d = x.shape
    n = B * s_loc
    x2d = x.reshape(n, d)
    top_w, top_e, aux = _route(SimpleNamespace(router=router), x2d, cfg)
    flat_e = top_e.reshape(-1)                        # (n*k,)
    order, sd, pos = _positions(flat_e // e_loc)      # by destination rank
    cap = max(8, -(-int(n * k / tp * cf) // 8) * 8)
    ok = pos < cap
    slot = torch.where(ok, sd * cap + pos, tp * cap)  # row of the send buffer
    send_x = _pack(x2d, slot, order, k, tp * cap + 1)
    send_e = torch.full((tp * cap + 1,), e, dtype=flat_e.dtype,
                        device=flat_e.device)
    send_e.index_copy_(0, slot, flat_e[order])
    # ship to expert owners: chunk j of the buffer to rank j
    recv_x = all_to_all(send_x[:tp * cap], g)
    recv_e = exchange(send_e[:tp * cap], g)
    le = recv_e - m * e_loc                           # local expert id
    valid = (le >= 0) & (le < e_loc)
    order2, se2, pos2 = _positions(torch.where(valid, le, e_loc))
    cap2 = max(8, -(-int(tp * cap / e_loc * cf) // 8) * 8)
    ok2 = (pos2 < cap2) & (se2 < e_loc)
    ex = SimpleNamespace(w_up=w_up, w_gate=w_gate, w_down=w_down)
    vals2 = _experts(ex, recv_x,
                     torch.ones((tp * cap, 1), dtype=torch.float32,
                                device=x2d.device), se2, pos2, order2, ok2,
                     0, e_loc, cap2, 1)               # (tp*cap, d), unpermuted
    back = all_to_all(vals2, g)                       # my slots, by dest
    # combine at source: slot (dest, pos) -> its token
    got = back.index_select(0, torch.clamp(sd, max=tp - 1) * cap
                            + torch.clamp(pos, max=cap - 1))
    got = torch.where(ok[:, None], got, 0.0)
    w_sorted = top_w.reshape(-1)[order].to(got.dtype)
    slots = torch.empty_like(got).index_copy_(0, order,
                                              got * w_sorted[:, None])
    y = slots.view(B, s_loc, k, d).sum(dim=2)
    return y, mean_over(aux, g)


def moe_forward(p: MoE, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Shared experts always run densely.

    The form is the reference's choice, from ``cfg.moe_impl`` and the
    installed context: ``auto`` takes ``ep`` when the context allows the
    expert-parallel forms, its model group has more than one rank and the
    experts split evenly over it, else ``dense``; ``ep_a2a`` gives way to
    ``ep`` where the sequence or the experts do not split (decode); with no
    context every form is ``dense``."""
    B, S, d = x.shape
    ctx = get_parallel_context()
    impl = cfg.moe_impl
    ep_ok = ctx is not None and ctx.allow_shardmap_layers
    if impl == "auto":
        impl = "ep" if (ep_ok and ctx.tp_size > 1
                        and cfg.moe_experts % ctx.tp_size == 0) else "dense"
    if impl == "ep_a2a" and ep_ok:
        tp = ctx.tp_size
        if S % tp == 0 and cfg.moe_experts % tp == 0:
            y, aux = _moe_ep_a2a(p, x, cfg)
        else:  # decode (S=1) or non-divisible: fall back to psum combine
            y, aux = _moe_ep_psum(p, x, cfg)
    elif impl == "ep" and ep_ok:
        y, aux = _moe_ep_psum(p, x, cfg)
    else:
        x2d = x.reshape(B * S, d)
        # the reference's dense path is one program over the global batch:
        # route the data group's tokens, keep this rank's rows (a DTensor
        # holds the global batch already). Inside an explicit sync mode
        # (its data-manual ``shard_map``, where the expert-parallel forms
        # are off too) it routes per data rank.
        gather = (ctx is not None and ctx.allow_shardmap_layers
                  and ctx.dp_size > 1 and not isinstance(x, DTensor))
        if gather:
            x2d = gather_rows(x2d, ctx.data_groups, ctx.data_index)
        y2d, aux = _moe_dense(p, x2d, cfg)
        if gather:
            y2d = y2d.narrow(0, ctx.data_index * B * S, B * S)
        y = y2d.view(B, S, d)
    if hasattr(p, "shared"):
        y = y + mlp_forward(p.shared, x, "swiglu")
    return y, aux
