"""A step's trace of the CUDA caching allocator replayed to its peak: the
blocks live there and the line of the port's code that made each.

Take ``torch.cuda.memory._snapshot()`` before the step with
``torch.cuda.memory._record_memory_history(context="alloc",
stacks="python")`` on, and again after it; :func:`blocks_at_peak` starts
from the blocks live in the first and replays the allocations and frees
the second recorded since.
"""
from __future__ import annotations

from typing import Dict, Tuple


def origin(frames) -> str:
    """The first frame of the port's code in an allocation's stack (else
    its innermost frame; ``"?"`` with no stack)."""
    for f in frames:
        if "repro_torch" in f["filename"]:
            return (f"{f['filename'].split('repro_torch/')[-1]}:{f['line']} "
                    f"{f['name']}")
    return f"{frames[0]['filename']}:{frames[0]['line']}" if frames else "?"


def blocks_at_peak(before, after, held: str = "held before the step"
                   ) -> Tuple[int, Dict[int, Tuple[int, str]]]:
    """``(peak, {address: (bytes, where)})``: the peak bytes of the trace
    between two snapshots and the blocks live at it, ``where`` the
    :func:`origin` of the allocation; a block live before the step is
    ``"before the step: "`` and its origin, or ``held`` and its size where
    no stack was recorded for it."""
    live = {}
    for seg in before["segments"]:
        addr = seg["address"]
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                where = origin(b["frames"]) if b.get("frames") \
                    else f"{held} ({b['size']} B)"
                live[addr] = (b["size"], "before the step: " + where)
            addr += b["size"]
    start = len(before["device_traces"][0])
    events = [e for e in after["device_traces"][0][start:]
              if e["action"] in ("alloc", "free_requested")]
    cur = peak = sum(n for n, _ in live.values())
    at = -1
    for i, e in enumerate(events):       # the peak's index
        cur += e["size"] if e["action"] == "alloc" else -e["size"]
        if cur > peak:
            peak, at = cur, i
    for e in events[:at + 1]:            # the blocks live at the peak
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], origin(e.get("frames", [])))
        else:
            live.pop(e["addr"], None)
    return peak, live
