"""Carry state across from the reference package.

Two kinds of state cross: the recorded schedule, whose public fields are
read by attribute to build the port's
:class:`~repro_torch.core.trace.schedule.Schedule` (so both executors
replay the identical tree), and a model's weights, handed over as the
reference's parameter pytree of numpy arrays. This module imports nothing
of the reference and nothing of JAX.
"""
from __future__ import annotations

from typing import Iterable, List, Mapping

import numpy as np
import torch
from torch import nn

from .core.trace.schedule import CopyStep, ReduceStep, Schedule
from .kernels.ops import resolve_device
from .models.config import ModelConfig
from .models.transformer import Transformer, layer_period


def schedule_from_reference(obj) -> Schedule:
    """The port's :class:`Schedule` with every field of ``obj``."""
    return Schedule(
        app=int(obj.app), block=int(obj.block), gen=int(obj.gen),
        root=int(obj.root), hosts=[int(h) for h in obj.hosts],
        leaf_host={int(n): int(h) for n, h in obj.leaf_host.items()},
        reduce_rounds=[[ReduceStep(dst=int(s.dst),
                                   srcs=tuple(int(c) for c in s.srcs))
                        for s in rnd] for rnd in obj.reduce_rounds],
        bcast_rounds=[[CopyStep(src=int(s.src),
                                dsts=tuple(int(c) for c in s.dsts))
                       for s in rnd] for rnd in obj.bcast_rounds],
        timeout_flushes=int(obj.timeout_flushes),
        complete_flushes=int(obj.complete_flushes))


def schedules_from_reference(objs: Iterable) -> List[Schedule]:
    return [schedule_from_reference(o) for o in objs]


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """``a`` as a CPU tensor of its own dtype, every bit kept.

    ``torch.from_numpy`` rejects ``ml_dtypes.bfloat16``; such an array goes
    through its 16-bit pattern (``view(int16)``, then
    ``view(torch.bfloat16)``).
    """
    a = np.array(a, copy=True, order="C")      # writable, and not shared
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def params_from_reference(np_params: Mapping, cfg: ModelConfig,
                          device=None) -> Transformer:
    """The port's :class:`Transformer` holding the reference's weights.

    ``np_params`` is the reference's ``init_params`` pytree after
    ``jax.tree.map(np.asarray, params)``: ``embed``, ``final_norm`` and
    ``layers``, a list (one entry per layer period) of leaves stacked with
    a leading ``num_layers // period`` axis. Each leaf keeps its dtype and
    bits. Every parameter of the module must be given, and nothing else.
    ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    model = Transformer(cfg, device="meta")
    per = layer_period(cfg)
    leaves = {f"embed.{k}": v for k, v in _flatten(np_params["embed"]).items()}
    leaves.update({f"final_norm.{k}": v
                   for k, v in _flatten(np_params["final_norm"]).items()})
    for j, stacked in enumerate(np_params["layers"]):
        for name, a in _flatten(stacked).items():
            for i in range(a.shape[0]):
                leaves[f"layers.{i * per + j}.{name}"] = a[i]
    expected = dict(model.named_parameters())
    if set(leaves) != set(expected):
        raise KeyError(f"reference leaves and {cfg.name}'s parameters differ:"
                       f" missing {sorted(set(expected) - set(leaves))}, "
                       f"unexpected {sorted(set(leaves) - set(expected))}")
    for name, a in leaves.items():
        t = tensor_from_numpy(a)
        if tuple(t.shape) != tuple(expected[name].shape):
            raise ValueError(f"{name}: reference shape {tuple(t.shape)}, "
                             f"port {tuple(expected[name].shape)}")
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        setattr(owner, leaf, nn.Parameter(t.to(dev), requires_grad=False))
    return model
