"""Mixture-of-Experts layer (port of ``repro/models/moe.py``): shared and
routed experts, top-k routing with a fixed capacity, sort-and-scatter
dispatch (no O(tokens^2) one-hot products).

Routing follows DeepSeekMoE / Qwen2-MoE: float32 router logits, softmax,
top-k, renormalised weights, and a Switch-style load-balancing auxiliary
loss. The reference's single-device ``dense`` path is ported; with no
parallel context every ``moe_impl`` takes it, as the reference's does. The
expert-parallel forms (``_moe_ep_shardmap``, ``_moe_ep_a2a_shardmap``)
wait for the port's mesh (``ROADMAP.md`` queue 1, item 12).

Where the port differs in form, and why:

* The reference scatters tokens into the capacity buffer with
  ``mode="drop"``, which discards writes past the capacity. PyTorch has no
  such mode, so a dropped slot is written to one spare row past the buffer,
  which is then cut off.
* The reference combines with a scatter-add over tokens. On the card
  ``index_add_`` adds with atomics, whose order (and so the bf16 bits)
  changes from run to run; the port un-permutes the slots to (N, k, d) and
  sums over k instead, the same bits every run.

No step syncs with the host: the kept and dropped slots are masks on the
device, and the experts' loads are a scatter-add, not ``bincount`` (which
reads its output's size from the card).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

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
    frac = torch.zeros((e,), dtype=torch.float32, device=flat.device
                       ).scatter_add_(0, flat, torch.ones_like(
                           flat, dtype=torch.float32))
    frac = frac / top_e.numel()
    pmean = probs.mean(dim=0)
    aux = e * torch.sum(frac * pmean)
    return top_w, top_e, aux


def _dispatch_indices(top_e: torch.Tensor, k: int, num_experts: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort slots by expert; return (sorted expert id, position-in-expert,
    source slot order). The sort is stable and the search takes the left
    end, as ``jnp.argsort`` / ``jnp.searchsorted`` do, so the same slots
    come first in each expert and the same ones drop at capacity."""
    flat_e = top_e.reshape(-1)                                    # (N*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(sorted_e.shape[0], device=top_e.device) - first
    return sorted_e, pos_in_e, order


def _expert_ffn(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d) through each expert's SwiGLU FFN."""
    up = torch.einsum("ecd,edf->ecf", buf, p.w_up)
    gate = torch.einsum("ecd,edf->ecf", buf, p.w_gate)
    h = F.silu(gate) * up
    return torch.einsum("ecf,efd->ecd", h, p.w_down)


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.moe_top_k * cfg.moe_capacity_factor
            / cfg.moe_experts) + 1
    # padded to a multiple of 8 as the reference pads (for TPU layouts):
    # the same capacity keeps the same slots
    return max(8, -(-c // 8) * 8)


def _moe_dense(p: MoE, x2d: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    n, d = x2d.shape
    k, e = cfg.moe_top_k, cfg.moe_experts
    top_w, top_e, aux = _route(p, x2d, cfg)
    sorted_e, pos_in_e, order = _dispatch_indices(top_e, k, e)
    cap = _capacity(n, cfg)
    keep = pos_in_e < cap
    src_tok = order // k
    # rows of the flattened (E * cap + 1, d) buffer; a dropped slot lands in
    # the last row, cut off below
    dest = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=x2d.dtype, device=x2d.device)
    buf.index_copy_(0, dest, x2d.index_select(0, src_tok))
    out = _expert_ffn(p, buf[:e * cap].view(e, cap, d))
    vals = out.reshape(e * cap, d).index_select(
        0, sorted_e * cap + torch.clamp(pos_in_e, max=cap - 1))
    vals = torch.where(keep[:, None], vals, 0.0)
    w_sorted = top_w.reshape(-1)[order].to(vals.dtype)
    # un-permute to (N, k, d) and sum over k: no atomics, the same bits
    slots = torch.empty_like(vals).index_copy_(0, order,
                                               vals * w_sorted[:, None])
    return slots.view(n, k, d).sum(dim=1), aux


def moe_forward(p: MoE, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Shared experts always run densely.

    The port has no parallel context, so every ``cfg.moe_impl`` takes the
    dense path, as the reference's does without one."""
    B, S, d = x.shape
    y2d, aux = _moe_dense(p, x.reshape(B * S, d), cfg)
    y = y2d.view(B, S, d)
    if hasattr(p, "shared"):
        y = y + mlp_forward(p.shared, x, "swiglu")
    return y, aux
