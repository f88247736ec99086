"""AdamW with decoupled weight decay, global-norm clipping and configurable
state dtype (port of ``repro/optim/adamw.py``): fp32 moments by default,
bf16 moments for memory-tight configs.

Parameters, gradients and moments are name -> tensor mappings (an
``nn.Module`` is read through ``named_parameters()``). The arithmetic
follows the reference operation for operation in float32 under
``torch.no_grad()``. Unlike the reference, which returns new arrays,
:func:`update` writes the new parameters and moments into the tensors it
was given (no second copy of a 1 B-parameter model and its moments on the
card) and returns them. Nothing here copies a value to the host. A model's
weights decay where the reference's do: the reference decays a leaf of two
or more dimensions, and it stacks each layer's parameters along a leading
axis, so every per-layer tensor of the port (a layer's norm scales too)
decays, and of the rest those of two or more dimensions.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..models.layers import torch_dtype


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # moments dtype; bf16 halves optimizer HBM
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


class AdamWState(NamedTuple):
    step: torch.Tensor             # 0-d int32, on the parameters' device
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def named(params: Any) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters or of a mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


@lru_cache(maxsize=None)
def _stacked_names(cfg) -> frozenset:
    from ..convert import reference_leaves      # convert imports this module
    return frozenset(n for leaf in reference_leaves(cfg) if leaf.stacked
                     for n in leaf.names)


def _decays(params: Any, p_named: Dict[str, torch.Tensor]) -> set:
    """The names whose weights decay: those of two or more dimensions in the
    reference's pytree, where a model's layers are stacked along a leading
    axis (so each layer's norm scales decay there, and here)."""
    stacked = _stacked_names(params.cfg) if hasattr(params, "cfg") \
        else frozenset()
    return {n for n, p in p_named.items() if p.ndim + (n in stacked) >= 2}


def init(params: Any, cfg: AdamWConfig) -> AdamWState:
    dt = torch_dtype(cfg.state_dtype)
    p = named(params)
    dev = next(iter(p.values())).device
    zeros = {k: torch.zeros(t.shape, dtype=dt, device=t.device)
             for k, t in p.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros,
                      v={k: torch.zeros_like(t) for k, t in zeros.items()})


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32."""
    leaves = tree.values() if isinstance(tree, Mapping) else tree
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.to(torch.float32))) for x in leaves])))


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``like``'s device, so that a
    division by a tensor is an IEEE division (``python_float / tensor`` is a
    reciprocal product in PyTorch)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


@torch.no_grad()
def update(grads: Mapping[str, torch.Tensor], state: AdamWState, params: Any,
           cfg: AdamWConfig
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step. Writes the new parameters into ``params``' tensors
    and the new moments into ``state``'s; returns ``(params, state with the
    step advanced, {"grad_norm", "lr"})``, the metrics 0-d float32 tensors
    on the device."""
    p_named = named(params)
    if set(grads) != set(p_named):
        raise KeyError(f"gradients and parameters differ: "
                       f"{sorted(set(grads) ^ set(p_named))}")
    step = state.step + 1
    lr = cfg.lr if cfg.schedule is None else cfg.schedule(step)
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        scale = torch.minimum(_f32(1.0, gnorm), torch.div(
            _f32(cfg.grad_clip, gnorm), torch.clamp(gnorm, min=1e-9)))
    else:
        scale = _f32(1.0, gnorm)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, stepf), stepf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, stepf), stepf)
    decays = _decays(params, p_named) if cfg.weight_decay > 0 else set()

    for name, p in p_named.items():
        g, m, v = grads[name], state.m[name], state.v[name]
        g32 = g.to(torch.float32) * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(g32)
        mhat = m32 / b1c
        vhat = v32 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.to(torch.float32)
        if name in decays:     # the reference's ``p.ndim >= 2``
            delta = delta + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m32)                               # rounds to state_dtype
        v.copy_(v32)
    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr, dtype=torch.float32,
                                     device=gnorm.device)}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
