"""Side-effect-free dry-run analysis helpers (importable anywhere —
no XLA_FLAGS mutation; see repro.launch.dryrun for the driver)."""
from __future__ import annotations

import re
import warnings
from typing import Dict

from ..models.config import ModelConfig

INPUT_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# dtypes we have already warned about (warn once per process, not per line)
_WARNED_DTYPES: set = set()


def parse_collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Sum result-shape bytes of every collective op in the optimized HLO.

    all-reduce moves ~2x its payload per device (reduce + broadcast phases /
    ring equivalents); the others move ~1x their result. The returned
    ``total_link_bytes`` applies those multipliers — the §Roofline collective
    term divides it by the per-link bandwidth.

    A dtype missing from ``_DTYPE_BYTES`` is assumed 4 bytes wide; rather
    than doing that silently, every occurrence is tallied in the returned
    ``unknown_dtypes`` field (dtype -> op count) and a ``RuntimeWarning`` is
    emitted once per dtype per process, so a new XLA dtype cannot skew the
    roofline unnoticed.
    """
    out = {k: 0.0 for k in _COLLECTIVES}
    count = {k: 0 for k in _COLLECTIVES}
    unknown: Dict[str, int] = {}
    # e.g.:  %all-reduce.1 = bf16[1024,512]{1,0} all-reduce(...)
    shape_re = re.compile(
        r"=\s+(?:\()?([a-z0-9]+)\[([0-9,]*)\][^ ]*\s+([a-z\-]+)")
    for line in hlo_text.splitlines():
        hit = None
        for c in _COLLECTIVES:
            if f" {c}(" in line or f" {c}-start(" in line:
                hit = c
                break
        if hit is None:
            continue
        m = shape_re.search(line)
        if not m:
            continue
        dtype, dims, _ = m.groups()
        size = _DTYPE_BYTES.get(dtype)
        if size is None:
            size = 4
            unknown[dtype] = unknown.get(dtype, 0) + 1
        for d in dims.split(","):
            if d:
                size *= int(d)
        out[hit] += size
        count[hit] += 1
    for dtype in unknown:
        if dtype not in _WARNED_DTYPES:
            _WARNED_DTYPES.add(dtype)
            warnings.warn(
                f"parse_collective_bytes: unknown HLO dtype {dtype!r} — "
                "assuming 4 bytes/element; add it to _DTYPE_BYTES",
                RuntimeWarning, stacklevel=2)
    total = sum(v * (2.0 if k == "all-reduce" else 1.0)
                for k, v in out.items())
    return {"per_op_bytes": out, "per_op_count": count,
            "total_link_bytes": total, "unknown_dtypes": unknown}


def model_flops_per_step(cfg: ModelConfig, kind: str, seq: int,
                         global_batch: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference) with N = active
    params; decode processes D = batch tokens per step."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = global_batch * seq
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = global_batch * seq
        return 2.0 * n_active * tokens
    return 2.0 * n_active * global_batch  # decode: one token per sequence
