"""Carry state across from the reference package.

This system has no weights: its state is the recorded schedule. These
functions read a reference ``Schedule``'s public fields by attribute (so
this module imports nothing of the reference) and build the port's
:class:`~repro_torch.core.trace.schedule.Schedule`, so both executors can
replay the identical tree.
"""
from __future__ import annotations

from typing import Iterable, List

from .core.trace.schedule import CopyStep, ReduceStep, Schedule


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
