"""Lower compiled schedules into a replay plan: one gathered segment-sum per
tree level.

A :class:`~.schedule.Schedule` is a list of reduce rounds for one block;
replaying round by round costs one kernel launch per round per block. The
plan instead numbers every block's switch nodes into one scratch table and
merges the same round (height level) of every block into one CSR, so a
whole app replays in one launch per level:

* ``src`` row references are either a leaf row ``rank * B + b`` of the
  ``(P, B, D)`` input (``>= 0``) or a scratch row ``r`` (stored as
  ``-1 - r``); each segment lists its step's ``srcs`` in merge order;
* ``dst`` is the scratch row a segment writes, or ``-1 - b`` for block
  ``b``'s root, whose sum is written to row ``b`` of every participant's
  output (the broadcast of §3.1.2).

A step of fan-in 1 below the root copies its child unchanged, so it gets no
segment: its node aliases the child's row. A level can therefore hold no
segment. A row written at level ``l`` is read only at a later level, since
a step's children all have a smaller height. A block whose tree is a single
leaf (no reduce rounds) gets one fan-in-1 root segment at level 0.

The plan depends only on the schedules: lower once with
:func:`lower_schedules`, and hand the plan to ``replay_app`` /
``fixed_point_replay`` in place of the schedules for every later replay.
Its index arrays are copied to a device once, at the first replay there.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .schedule import ReduceStep, Schedule


@dataclass(frozen=True)
class Level:
    """One height level of every block: ``out[dst[s]] = sum of the rows
    src[seg_offsets[s]:seg_offsets[s + 1]]``."""

    seg_offsets: np.ndarray    # int32 (S + 1,)
    src: np.ndarray            # int32 (seg_offsets[-1],)
    dst: np.ndarray            # int32 (S,)

    @property
    def num_segments(self) -> int:
        return len(self.dst)


@dataclass(frozen=True, eq=False)
class ReplayPlan:
    """The replay of ``blocks`` schedules over ``hosts`` participants."""

    hosts: int
    blocks: int
    scratch_rows: int
    levels: Tuple[Level, ...]
    _on_device: Dict[torch.device, list] = field(default_factory=dict,
                                                 repr=False)

    @property
    def num_sources(self) -> int:
        return sum(len(lv.src) for lv in self.levels)

    @property
    def num_segments(self) -> int:
        return sum(lv.num_segments for lv in self.levels)

    def on(self, device: torch.device) -> List[Tuple[torch.Tensor, ...]]:
        """Each level's ``(seg_offsets, src, dst)`` as int32 tensors on
        ``device``, copied there at the first call."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = [
                tuple(torch.from_numpy(a).to(device) for a in
                      (lv.seg_offsets, lv.src, lv.dst))
                for lv in self.levels]
        return self._on_device[device]


def lower_schedules(schedules: Sequence[Schedule]) -> ReplayPlan:
    """The :class:`ReplayPlan` of an app's schedules (block ``b`` is
    ``schedules[b]``, its participants in ``schedules[b].hosts`` order)."""
    if not schedules:
        raise ValueError("no schedules to lower")
    nb = len(schedules)
    p = len(schedules[0].hosts)
    depth = max(max(s.depth for s in schedules), 1)
    fanin: List[List[int]] = [[] for _ in range(depth)]
    srcs: List[List[int]] = [[] for _ in range(depth)]
    dsts: List[List[int]] = [[] for _ in range(depth)]
    rows = 0
    for b, sched in enumerate(schedules):
        if len(sched.hosts) != p:
            raise ValueError(f"schedule {b} has {len(sched.hosts)} "
                             f"participants, schedule 0 has {p}")
        rank = {h: r for r, h in enumerate(sched.hosts)}
        try:
            ref = {nid: rank[h] * nb + b for nid, h in sched.leaf_host.items()}
        except KeyError as e:
            raise ValueError(f"schedule {b}: leaf host {e} is not a "
                             f"participant") from None
        rounds = sched.reduce_rounds or [[ReduceStep(sched.root,
                                                     (sched.root,))]]
        for lvl, rnd in enumerate(rounds):
            for step in rnd:
                try:
                    step_srcs = [ref[c] for c in step.srcs]
                except KeyError as e:
                    raise ValueError(f"schedule {b}: node {e} is read before "
                                     f"it is written") from None
                if step.dst == sched.root:
                    dsts[lvl].append(-1 - b)
                elif len(step_srcs) == 1:
                    ref[step.dst] = step_srcs[0]
                    continue
                else:
                    ref[step.dst] = -1 - rows
                    dsts[lvl].append(rows)
                    rows += 1
                srcs[lvl].extend(step_srcs)
                fanin[lvl].append(len(step_srcs))
    levels = []
    for f, s, d in zip(fanin, srcs, dsts):
        seg = np.zeros(len(f) + 1, dtype=np.int64)
        np.cumsum(f, out=seg[1:])
        if seg[-1] >= 2 ** 31 or p * nb >= 2 ** 31 or rows >= 2 ** 31:
            raise ValueError("the plan's row indices exceed int32")
        levels.append(Level(seg_offsets=seg.astype(np.int32),
                            src=np.asarray(s, dtype=np.int32),
                            dst=np.asarray(d, dtype=np.int32)))
    return ReplayPlan(hosts=p, blocks=nb, scratch_rows=rows,
                      levels=tuple(levels))
