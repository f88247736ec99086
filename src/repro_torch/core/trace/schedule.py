"""Schedule compiler: lower a recorded dynamic tree to a round-based program.

A :class:`~repro.core.trace.recorder.BlockTree` is an *event history*; this
module lowers it into a deterministic, data-parallel communication schedule
over a logical device mesh:

* **reduce rounds** — round ``r`` holds one :class:`ReduceStep` per tree node
  whose height is ``r``: the node accumulates all of its children's buffers.
  Steps within a round touch disjoint destinations and only read buffers
  produced in earlier rounds, so a round is a single segment-sum — exactly
  the shape :func:`repro.kernels.packet_accum.packet_accumulate` executes on
  the MXU.
* **broadcast rounds** — the mirror image (root to leaves), matching §3.1.2:
  the broadcast rides the recorded tree back down.

The compiler is pure Python (no jax): schedules are inspectable/serializable
artifacts; :mod:`~repro.core.trace.executor` turns them into tensor programs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .recorder import HOST_SEND, BlockTree, TraceRecorder


@dataclass(frozen=True)
class ReduceStep:
    """``dst`` accumulates the sum of every buffer in ``srcs``."""

    dst: int            # node id
    srcs: tuple         # child node ids, merge order


@dataclass(frozen=True)
class CopyStep:
    """``src``'s buffer is replicated into every node in ``dsts``."""

    src: int
    dsts: tuple


@dataclass
class Schedule:
    """Round-based replay program for one block's recorded tree."""

    app: int
    block: int
    gen: int
    root: int                                  # root node id
    hosts: List[int]                           # participants, sorted
    leaf_host: Dict[int, int]                  # leaf node id -> host id
    reduce_rounds: List[List[ReduceStep]] = field(default_factory=list)
    bcast_rounds: List[List[CopyStep]] = field(default_factory=list)
    # provenance stats carried over from the recorded tree
    timeout_flushes: int = 0
    complete_flushes: int = 0

    # ---- derived metrics ---------------------------------------------------
    @property
    def depth(self) -> int:
        return len(self.reduce_rounds)

    @property
    def num_reduce_steps(self) -> int:
        return sum(len(r) for r in self.reduce_rounds)

    @property
    def max_fanin(self) -> int:
        return max((len(s.srcs) for r in self.reduce_rounds for s in r),
                   default=0)

    def message_count(self) -> int:
        """Logical point-to-point transfers (reduce edges + broadcast edges)."""
        up = sum(len(s.srcs) for r in self.reduce_rounds for s in r)
        down = sum(len(s.dsts) for r in self.bcast_rounds for s in r)
        return up + down

    def bytes_moved(self, block_bytes: int) -> int:
        return self.message_count() * block_bytes

    def summary(self) -> str:
        return (f"app={self.app} block={self.block} depth={self.depth} "
                f"steps={self.num_reduce_steps} max_fanin={self.max_fanin} "
                f"messages={self.message_count()}")


def compile_block(tree: BlockTree) -> Schedule:
    """Lower one recorded :class:`BlockTree` into a :class:`Schedule`."""
    # height of each node above its deepest leaf (leaves are 0)
    height: Dict[int, int] = {}

    def _height(nid: int) -> int:
        h = height.get(nid)
        if h is not None:
            return h
        node = tree.nodes[nid]
        h = 0 if not node.children else 1 + max(_height(c)
                                                for c in node.children)
        height[nid] = h
        return h

    max_h = _height(tree.root)
    reduce_rounds: List[List[ReduceStep]] = [[] for _ in range(max_h)]
    for nid, node in sorted(tree.nodes.items()):
        if node.children:
            reduce_rounds[height[nid] - 1].append(
                ReduceStep(dst=nid, srcs=tuple(node.children)))

    # broadcast mirrors the reduce tree root-to-leaves by node depth
    depth: Dict[int, int] = {tree.root: 0}
    order = [tree.root]
    for nid in order:
        for c in tree.nodes[nid].children:
            depth[c] = depth[nid] + 1
            order.append(c)
    max_d = max(depth.values(), default=0)
    bcast_rounds: List[List[CopyStep]] = [[] for _ in range(max_d)]
    for nid, node in sorted(tree.nodes.items()):
        if node.children:
            bcast_rounds[depth[nid]].append(
                CopyStep(src=nid, dsts=tuple(node.children)))

    leaf_host = {nid: n.where for nid, n in tree.nodes.items()
                 if n.kind == HOST_SEND}
    return Schedule(app=tree.app, block=tree.block, gen=tree.gen,
                    root=tree.root, hosts=list(tree.participants),
                    leaf_host=leaf_host,
                    reduce_rounds=reduce_rounds, bcast_rounds=bcast_rounds,
                    timeout_flushes=tree.timeout_flushes(),
                    complete_flushes=tree.complete_flushes())


def compile_app(recorder: TraceRecorder, app: int) -> List[Schedule]:
    """Compile every completed block of ``app``, ordered by block index."""
    return [compile_block(t) for t in recorder.trees(app)]


def schedule_report(schedules: List[Schedule], block_bytes: int) -> dict:
    """Aggregate schedule-shape metrics for a set of compiled blocks."""
    depths = [s.depth for s in schedules]
    return {
        "blocks": len(schedules),
        "depth_max": max(depths, default=0),
        "depth_mean": (sum(depths) / len(depths)) if depths else 0.0,
        "reduce_steps": sum(s.num_reduce_steps for s in schedules),
        "messages": sum(s.message_count() for s in schedules),
        "bytes_moved": sum(s.bytes_moved(block_bytes) for s in schedules),
        "timeout_flushes": sum(s.timeout_flushes for s in schedules),
        "complete_flushes": sum(s.complete_flushes for s in schedules),
        "max_fanin": max((s.max_fanin for s in schedules), default=0),
    }
