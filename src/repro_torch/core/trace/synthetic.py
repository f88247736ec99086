"""Seeded synthetic schedules with a skewed fan-in, for the replay plan's
tests and the gathered kernel's checks on the card (``chip_smoke.py``).

Recorded traces are deep and skewed: most steps have fan-in 1, a few at the
top gather a hundred children or more. :func:`random_schedules` makes trees
of that shape without running the simulator.
"""
from __future__ import annotations

import random
from typing import List, Tuple

from .schedule import ReduceStep, Schedule

DEPTH = 4   # the most levels a tree gets: the recorded traces' depth


def random_schedules(hosts: int, blocks: int, seed: int = 0) -> List[Schedule]:
    """``blocks`` schedules over ``hosts`` participants: block 0 is a root
    over every leaf (fan-in ``hosts``), the others random trees of at most
    :data:`DEPTH` levels whose steps are mostly of fan-in 1 with a few wide
    ones."""
    rng = random.Random(seed)
    out = []
    for b in range(blocks):
        leaves = list(range(hosts))
        rng.shuffle(leaves)
        nodes = [(nid, 0) for nid in leaves]        # (node id, height)
        steps: List[Tuple[int, int, tuple]] = []    # (height, dst, srcs)
        nid = hosts
        for level in range(1, DEPTH + 1):
            if len(nodes) == 1 and level > 1:
                break
            groups, i = [], 0
            while i < len(nodes):
                if b == 0 or level == DEPTH:
                    k = len(nodes)
                elif rng.random() < 0.6:
                    k = 1
                else:
                    k = rng.randint(2, max(2, len(nodes) // 3))
                groups.append(nodes[i:i + k])
                i += k
            nodes = []
            for g in groups:
                h = 1 + max(ht for _, ht in g)
                steps.append((h, nid, tuple(n for n, _ in g)))
                nodes.append((nid, h))
                nid += 1
            if b == 0:
                break
        height = max(h for h, _, _ in steps)
        rounds: List[List[ReduceStep]] = [[] for _ in range(height)]
        for h, dst, srcs in sorted(steps):
            rounds[h - 1].append(ReduceStep(dst=dst, srcs=srcs))
        out.append(Schedule(app=0, block=b, gen=0, root=nodes[0][0],
                            hosts=list(range(hosts)),
                            leaf_host={h: h for h in range(hosts)},
                            reduce_rounds=rounds))
    return out
