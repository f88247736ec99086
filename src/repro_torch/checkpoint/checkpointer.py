"""Checkpointing (port of ``repro/checkpoint/checkpointer.py``): parameters
and optimizer state saved with a shape/dtype manifest.

Layout, the reference's: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``
(leaf names, shapes, dtypes, step). npz has no bfloat16, so bf16 leaves are
stored as a lossless float32 upcast and cast back on restore. Restore checks
the manifest against the target and writes the saved values into the
target's tensors, on their devices. Deterministic data
(``repro_torch.data``) makes (checkpoint step -> batch stream) resume exact.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..optim.adamw import AdamWState, named


def _leaves(params: Any, opt_state: Optional[AdamWState]
            ) -> Dict[str, torch.Tensor]:
    """``{name: tensor}``: ``params.<parameter>`` and, with an optimizer
    state, ``opt.step``, ``opt.m.<parameter>``, ``opt.v.<parameter>``."""
    out = {f"params.{k}": v for k, v in named(params).items()}
    if opt_state is not None:
        out["opt.step"] = opt_state.step
        for field in ("m", "v"):
            out.update({f"opt.{field}.{k}": t
                        for k, t in getattr(opt_state, field).items()})
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def save_checkpoint(directory: str, step: int, params: Any,
                    opt_state: Optional[AdamWState] = None) -> str:
    path = os.path.join(directory, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    leaves = _leaves(params, opt_state)
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"leaf_{i}": _np(t) for i, t in enumerate(leaves.values())})
    manifest = {
        "step": step,
        "num_leaves": len(leaves),
        "names": list(leaves),
        "shapes": [list(t.shape) for t in leaves.values()],
        "dtypes": [str(t.dtype).removeprefix("torch.")
                   for t in leaves.values()],
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


def restore_checkpoint(directory: str, step: int, params_like: Any,
                       opt_like: Optional[AdamWState] = None
                       ) -> Tuple[Any, Optional[AdamWState], int]:
    """Write the checkpoint of ``step`` into ``params_like``'s (and
    ``opt_like``'s) tensors; returns ``(params_like, opt_like, step)``."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = _leaves(params_like, opt_like)
    if manifest["num_leaves"] != len(like):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, target has "
            f"{len(like)} — architecture mismatch?")
    if manifest["names"] != list(like):
        bad = sorted(set(manifest["names"]) ^ set(like))
        raise ValueError(f"checkpoint and target leaves differ: {bad}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(like))]
    for (name, ref), arr in zip(like.items(), arrays):
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                             f"target {tuple(ref.shape)}")
    with torch.no_grad():
        for ref, arr in zip(like.values(), arrays):
            ref.copy_(torch.from_numpy(arr))
    return params_like, opt_like, manifest["step"]
