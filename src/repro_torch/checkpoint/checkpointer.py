"""Checkpointing (port of ``repro/checkpoint/checkpointer.py``): parameters
and optimizer state in the reference's files, so either package restores
the other's checkpoint.

Layout, the reference's: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``
(``step``, ``num_leaves``, ``treedef``, ``shapes``, ``dtypes``). The leaves
are the reference's too: the state ``{"params": ..., "opt": AdamWState(step,
m, v)}`` in ``jax.tree_util`` order (dict keys sorted, so ``opt`` comes
before ``params``; the named tuple's fields in order), each parameter leaf
(and each moment's) the reference's stacked one: the port's per-layer
tensors of one position of the layer period stacked along a leading axis
(:func:`repro_torch.convert.reference_leaves`). Stacking and unstacking run
on the host. npz has no bfloat16, so bf16 leaves are stored as a lossless
float32 upcast and cast back on restore. Restore checks the leaf count and
every shape against the target and writes the saved values into the
target's tensors, on their devices. Deterministic data
(``repro_torch.data``) makes (checkpoint step -> batch stream) resume exact.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..convert import reference_leaves, tensor_from_numpy
from ..models.transformer import Transformer
from ..optim.adamw import AdamWState


def _layout(params: Transformer, opt_state: Optional[AdamWState]
            ) -> Tuple[List[Tuple[str, List[torch.Tensor], bool]], str]:
    """The reference's leaves of the state, in its order, as ``(label,
    the port tensors the leaf holds, stacked)``, and its treedef string."""
    if not isinstance(params, Transformer):
        raise TypeError(f"checkpoints hold the port's Transformer, whose "
                        f"config gives the reference's layout; got "
                        f"{type(params).__name__}")
    leaves = reference_leaves(params.cfg)

    def tree(prefix: str, source: dict):
        return [(prefix + ".".join(map(str, leaf.path)),
                 [source[n] for n in leaf.names], leaf.stacked)
                for leaf in leaves]
    out = []
    if opt_state is not None:
        out.append(("opt.step", [opt_state.step], False))
        out += tree("opt.m.", opt_state.m) + tree("opt.v.", opt_state.v)
    out += tree("params.", dict(params.named_parameters()))
    return out, _treedef([leaf.path for leaf in leaves],
                         opt_state is not None)


def _treedef(paths: List[tuple], with_opt: bool) -> str:
    """``str(treedef)`` of the state as ``jax.tree_util`` prints it."""
    root: dict = {}
    for path in paths:
        node = root
        for key, nxt in zip(path, path[1:]):
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = [] if isinstance(nxt, int) else {}
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        node[path[-1]] = "*"

    def show(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"'{k}': {show(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(show(v) for v in node) + "]"
        return node
    params = show(root)
    state = f"'params': {params}"
    if with_opt:
        state = (f"'opt': CustomNode(namedtuple[AdamWState], [*, {params}, "
                 f"{params}]), " + state)
    return "PyTreeDef({" + state + "})"


def _np(tensors: List[torch.Tensor], stacked: bool) -> np.ndarray:
    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return np.stack([one(t) for t in tensors]) if stacked else one(tensors[0])


def _shape(tensors: List[torch.Tensor], stacked: bool) -> tuple:
    shape = tuple(tensors[0].shape)
    return (len(tensors),) + shape if stacked else shape


def save_checkpoint(directory: str, step: int, params: Transformer,
                    opt_state: Optional[AdamWState] = None) -> str:
    path = os.path.join(directory, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    leaves, treedef = _layout(params, opt_state)
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"leaf_{i}": _np(ts, stacked)
                for i, (_, ts, stacked) in enumerate(leaves)})
    manifest = {
        "step": step,
        "num_leaves": len(leaves),
        "treedef": treedef,
        "shapes": [list(_shape(ts, stacked)) for _, ts, stacked in leaves],
        "dtypes": [str(ts[0].dtype).removeprefix("torch.")
                   for _, ts, _ in leaves],
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, params_like: Transformer,
                       opt_like: Optional[AdamWState] = None
                       ) -> Tuple[Any, Optional[AdamWState], int]:
    """Write the checkpoint of ``step`` into ``params_like``'s (and
    ``opt_like``'s) tensors; returns ``(params_like, opt_like, step)``."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, _ = _layout(params_like, opt_like)
    if manifest["num_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, target has "
            f"{len(leaves)} — architecture mismatch?")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(leaves))]
    for (label, ts, stacked), arr in zip(leaves, arrays):
        if tuple(arr.shape) != _shape(ts, stacked):
            raise ValueError(f"{label}: checkpoint shape {arr.shape} != "
                             f"target {_shape(ts, stacked)}")
    with torch.no_grad():
        for (_, ts, stacked), arr in zip(leaves, arrays):
            for i, t in enumerate(ts):
                t.copy_(tensor_from_numpy(arr[i] if stacked else arr))
    return params_like, opt_like, manifest["step"]
