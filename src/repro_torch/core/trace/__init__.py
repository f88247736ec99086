"""Trace-and-replay: record, compile and execute dynamic trees.

Four stages; the first two as in the reference package:

1. :mod:`~.recorder` — :class:`TraceRecorder`, attached by the simulator when
   ``SimConfig(trace=True)``; reconstructs the dynamic tree every block
   actually rode (a copy of the reference module).
2. :mod:`~.schedule` — lowers a recorded :class:`BlockTree` into a
   round-based :class:`Schedule` (a copy of the reference module).
3. :mod:`~.plan` — merges an app's schedules into a :class:`ReplayPlan`:
   one gathered segment-sum per tree level across all blocks.
4. :mod:`~.executor` — replays the plan on tensors with the port's CUDA
   kernels (``packet_accumulate_gather`` once per level, ``quantize`` /
   ``dequantize`` for the bit-identical int32 mode).

Typical round trip::

    cfg = scaled_config(4, trace=True)
    sim = Simulator(cfg, jobs, algo=Algo.CANARY)
    sim.run()
    scheds = compile_app(sim.trace, app=0)
    plan = lower_schedules(scheds)             # once; reused by every replay
    out, q = fixed_point_replay(plan, x)       # on the card by default
"""
from .executor import (fixed_point_replay, reference_allreduce, replay_app,
                       replay_block)
from .plan import ReplayPlan, lower_schedules
from .recorder import (FLUSH_COMPLETE, FLUSH_TIMEOUT, HOST_SEND, LEADER,
                       STATIC_ROOT, SWITCH_DESC, BlockTree, TraceNode,
                       TraceRecorder)
from .schedule import (CopyStep, ReduceStep, Schedule, compile_app,
                       compile_block, schedule_report)

__all__ = [
    "BlockTree", "CopyStep", "FLUSH_COMPLETE", "FLUSH_TIMEOUT", "HOST_SEND",
    "LEADER", "ReduceStep", "ReplayPlan", "STATIC_ROOT", "SWITCH_DESC",
    "Schedule", "TraceNode", "TraceRecorder", "compile_app", "compile_block",
    "fixed_point_replay", "lower_schedules", "reference_allreduce",
    "replay_app", "replay_block", "schedule_report",
]
