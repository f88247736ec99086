"""Carry state across from the reference package.

Three kinds of state cross: the recorded schedule, whose public fields are
read by attribute to build the port's
:class:`~repro_torch.core.trace.schedule.Schedule` (so both executors
replay the identical tree), a model's weights, handed over as the
reference's parameter pytree of numpy arrays, and an AdamW state, its
moments shaped like those weights. :func:`reference_leaves` maps each leaf
of the reference's parameter pytree to the port's parameters it stacks;
the fixed-point sync takes one scale a reference leaf through it, and the
checkpointer reads and writes the reference's files through it. This
module imports nothing of the reference and nothing of JAX.
"""
from __future__ import annotations

from typing import Iterable, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from .core.trace.schedule import CopyStep, ReduceStep, Schedule
from .kernels.ops import resolve_device
from .models.config import ModelConfig
from .models.transformer import Transformer, layer_period
from .optim.adamw import AdamWState


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


class ReferenceLeaf(NamedTuple):
    """One leaf of the reference's parameter pytree: its ``path`` of keys
    and list indices (``("layers", 0, "attn", "wq")``), the port's
    parameter ``names`` it holds, in stacking order, and whether it stacks
    them along a new leading axis (every leaf under ``layers``, one entry a
    layer period) or holds the one parameter as it is."""

    path: Tuple
    names: Tuple[str, ...]
    stacked: bool


def reference_leaves(cfg: ModelConfig) -> List[ReferenceLeaf]:
    """The leaves of the reference's ``init_params`` pytree for ``cfg``, in
    ``jax.tree_util`` order (dict keys sorted, list entries in order), each
    with the port's parameter names it holds.

    The reference stacks the layers of each position ``j`` of the layer
    period into one leaf with a leading ``num_layers // period`` axis:
    the port's layer ``i * period + j`` is entry ``i`` of period entry
    ``j``. An encoder-decoder's ``encoder`` is one stack over its
    ``encoder_layers``: the port's ``encoder.i`` is entry ``i``. For
    llama3.2-1b (period 1, tied embeddings): 11 leaves over the port's 146
    parameters; for whisper-large-v3: 25 over 676.
    """
    per = layer_period(cfg)
    by_path: dict = {}
    for name, _ in Transformer(cfg, device="meta").named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            i = int(parts[1])
            path = ("layers", i % per, *parts[2:])
            by_path.setdefault(path, []).append((i // per, name))
        elif parts[0] == "encoder":
            by_path.setdefault(("encoder", *parts[2:]), []).append(
                (int(parts[1]), name))
        else:
            by_path[tuple(parts)] = [(0, name)]
    return [ReferenceLeaf(path, tuple(n for _, n in sorted(entries)),
                          path[0] in ("layers", "encoder"))
            for path, entries in sorted(by_path.items())]


def _reference_leaves(np_tree: Mapping, cfg: ModelConfig) -> dict:
    """``{port parameter name: array}`` of a pytree shaped like the
    reference's parameters (``embed``, ``final_norm``, ``layers``, a list
    with one entry per layer period of leaves stacked with a leading
    ``num_layers // period`` axis, and for an encoder-decoder ``enc_norm``
    and ``encoder``, leaves stacked over ``encoder_layers``); it must hold
    every parameter of the port's :class:`Transformer` and nothing else."""
    per = layer_period(cfg)
    leaves = {}
    for key, sub in np_tree.items():
        if key == "layers":
            for j, stacked in enumerate(sub):
                for name, a in _flatten(stacked).items():
                    for i in range(a.shape[0]):
                        leaves[f"layers.{i * per + j}.{name}"] = a[i]
        elif key == "encoder":
            for name, a in _flatten(sub).items():
                for i in range(a.shape[0]):
                    leaves[f"encoder.{i}.{name}"] = a[i]
        else:
            leaves.update({f"{key}.{k}": v for k, v in _flatten(sub).items()})
    expected = dict(Transformer(cfg, device="meta").named_parameters())
    if set(leaves) != set(expected):
        raise KeyError(f"reference leaves and {cfg.name}'s parameters differ:"
                       f" missing {sorted(set(expected) - set(leaves))}, "
                       f"unexpected {sorted(set(leaves) - set(expected))}")
    for name, a in leaves.items():
        if tuple(a.shape) != tuple(expected[name].shape):
            raise ValueError(f"{name}: reference shape {tuple(a.shape)}, "
                             f"port {tuple(expected[name].shape)}")
    return leaves


def params_from_reference(np_params: Mapping, cfg: ModelConfig,
                          device=None) -> Transformer:
    """The port's :class:`Transformer` holding the reference's weights.

    ``np_params`` is the reference's ``init_params`` pytree after
    ``jax.tree.map(np.asarray, params)``. Each leaf keeps its dtype and
    bits. ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    model = Transformer(cfg, device="meta")
    for name, a in _reference_leaves(np_params, cfg).items():
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        setattr(owner, leaf, nn.Parameter(tensor_from_numpy(a).to(dev),
                                          requires_grad=False))
    return model


def opt_state_from_reference(np_state, cfg: ModelConfig,
                             device=None) -> AdamWState:
    """The port's :class:`~repro_torch.optim.AdamWState` holding the
    reference's (``jax.tree.map(np.asarray, state)`` of its ``AdamWState``:
    ``step`` and the moments ``m`` and ``v``, shaped like the parameters).
    The moments are keyed by the port's parameter names and keep their
    dtype and bits. ``device=None`` means CUDA."""
    dev = resolve_device(device)

    def moments(tree):
        return {k: tensor_from_numpy(a).to(dev)
                for k, a in _reference_leaves(tree, cfg).items()}

    step = torch.tensor(int(np_state.step), dtype=torch.int32, device=dev)
    return AdamWState(step=step, m=moments(np_state.m),
                      v=moments(np_state.v))
