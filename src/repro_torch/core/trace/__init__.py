"""Trace-and-replay: record, compile and execute dynamic trees.

Three stages, as in the reference package:

1. :mod:`~.recorder` — :class:`TraceRecorder`, attached by the simulator when
   ``SimConfig(trace=True)``; reconstructs the dynamic tree every block
   actually rode (a copy of the reference module).
2. :mod:`~.schedule` — lowers a recorded :class:`BlockTree` into a
   round-based :class:`Schedule` (a copy of the reference module).
3. :mod:`~.executor` — replays schedules on tensors with the port's CUDA
   kernels (``packet_accumulate`` per reduce round, ``quantize`` /
   ``dequantize`` for the bit-identical int32 mode).

Typical round trip::

    cfg = scaled_config(4, trace=True)
    sim = Simulator(cfg, jobs, algo=Algo.CANARY)
    sim.run()
    scheds = compile_app(sim.trace, app=0)
    out, q = fixed_point_replay(scheds, x)     # on the card by default
"""
from .executor import (fixed_point_replay, reference_allreduce, replay_app,
                       replay_block)
from .recorder import (FLUSH_COMPLETE, FLUSH_TIMEOUT, HOST_SEND, LEADER,
                       STATIC_ROOT, SWITCH_DESC, BlockTree, TraceNode,
                       TraceRecorder)
from .schedule import (CopyStep, ReduceStep, Schedule, compile_app,
                       compile_block, schedule_report)

__all__ = [
    "BlockTree", "CopyStep", "FLUSH_COMPLETE", "FLUSH_TIMEOUT", "HOST_SEND",
    "LEADER", "ReduceStep", "STATIC_ROOT", "SWITCH_DESC", "Schedule",
    "TraceNode", "TraceRecorder", "compile_app", "compile_block",
    "fixed_point_replay", "reference_allreduce", "replay_app",
    "replay_block", "schedule_report",
]
