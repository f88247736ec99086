"""TraceRecorder: aggregation-provenance capture for simulator runs.

Canary's trees are *emergent* — switches allocate descriptors best-effort and
flush them on timeouts (§3.1.1), so no component of the system ever holds the
tree a block rode. The recorder reconstructs it by observing the dataplane:

* every host REDUCE send becomes a **leaf** :class:`TraceNode`;
* every switch descriptor becomes an **internal** node; merging a packet into
  a descriptor records a child edge (and the in-port, matching the children
  bitmap of §4.2);
* flushing a descriptor (timeout vs. complete) transfers the node onto the
  outgoing partial-aggregate packet;
* the leader's per-generation accumulation is the **root** node (for
  STATIC_TREE the root switch plays this role).

Packets and descriptors carry an inert ``trace_node`` tag (see
``canary/types.py``) that threads identity through the event loop; the
recorder allocates the tags and owns all derived state.

**Observation-only contract**: hooks never draw from the simulator RNG, never
push events and never mutate protocol state, so a traced run produces a
bit-identical :class:`~repro.core.canary.types.SimResult` to an untraced one
(pinned by the traced golden-replay test).

This module is jax-free — only :mod:`~repro.core.trace.executor` needs jax.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..canary.types import block_key, id_app, id_block, id_gen, make_id

# Node kinds
HOST_SEND = "host_send"    # a host's REDUCE send (tree leaf)
SWITCH_DESC = "switch_desc"  # a switch descriptor (internal aggregation node)
LEADER = "leader"          # leader-host accumulation (CANARY root)
STATIC_ROOT = "static_root"  # root-switch accumulation (STATIC_TREE root)

# Flush reasons for SWITCH_DESC nodes
FLUSH_COMPLETE = "complete"  # counter reached hosts-1 (§3.1.4)
FLUSH_TIMEOUT = "timeout"    # aggregation window expired (§3.1.1)


@dataclass
class TraceNode:
    """One aggregation point in a block's dynamic tree."""

    node_id: int
    kind: str                  # HOST_SEND | SWITCH_DESC | LEADER | STATIC_ROOT
    where: int                 # host id (leaves/leader) or global switch id
    pid: int                   # full block id incl. generation
    t_start: float
    children: List[int] = field(default_factory=list)   # node ids, merge order
    in_ports: List[int] = field(default_factory=list)   # per child edge (-1 at hosts)
    contribs: Counter = field(default_factory=Counter)  # host -> times aggregated
    flush_reason: Optional[str] = None                  # SWITCH_DESC only
    t_flush: float = -1.0

    @property
    def app(self) -> int:
        return id_app(self.pid)

    @property
    def block(self) -> int:
        return id_block(self.pid)

    @property
    def gen(self) -> int:
        return id_gen(self.pid)


@dataclass
class BlockTree:
    """The completed reduction tree of one ``(app, block)``.

    ``nodes`` maps node id -> :class:`TraceNode` for every node that
    contributed to the completed generation (stale-generation and dropped
    partials are excluded — they were rejected, so they are not part of the
    aggregation that produced the final value).
    """

    app: int
    block: int
    gen: int
    root: int                         # root node id
    nodes: Dict[int, TraceNode]
    participants: List[int]

    # ---- structure ---------------------------------------------------------
    def leaves(self) -> List[TraceNode]:
        return [n for n in self.nodes.values() if n.kind == HOST_SEND]

    def switch_nodes(self) -> List[TraceNode]:
        return [n for n in self.nodes.values() if n.kind == SWITCH_DESC]

    def depth(self) -> int:
        """Longest leaf-to-root path, in aggregation hops."""
        return self._level(self.root)

    def _level(self, nid: int) -> int:
        node = self.nodes[nid]
        if not node.children:
            return 0
        return 1 + max(self._level(c) for c in node.children)

    def timeout_flushes(self) -> int:
        return sum(1 for n in self.switch_nodes()
                   if n.flush_reason == FLUSH_TIMEOUT)

    def complete_flushes(self) -> int:
        return sum(1 for n in self.switch_nodes()
                   if n.flush_reason == FLUSH_COMPLETE)

    def max_fanin(self) -> int:
        return max((len(n.children) for n in self.nodes.values()), default=0)

    # ---- invariants --------------------------------------------------------
    def contributions(self) -> Counter:
        """host -> number of times its contribution reached the root."""
        return self.nodes[self.root].contribs

    def check_conservation(self) -> None:
        """Every participant aggregated exactly once — no loss, no
        double-count (the invariant that distinguishes Canary's best-effort
        trees from bounded-aggregation schemes)."""
        want = Counter({h: 1 for h in self.participants})
        got = self.contributions()
        if got != want:
            missing = sorted(h for h in want if got.get(h, 0) == 0)
            dupes = sorted(h for h, c in got.items() if c > 1)
            extra = sorted(h for h in got if h not in want)
            raise AssertionError(
                f"conservation violated for app={self.app} block={self.block} "
                f"gen={self.gen}: missing={missing} double={dupes} "
                f"foreign={extra}")

    def summary(self) -> str:
        return (f"app={self.app} block={self.block} gen={self.gen} "
                f"depth={self.depth()} switches={len(self.switch_nodes())} "
                f"timeout_flush={self.timeout_flushes()} "
                f"complete_flush={self.complete_flushes()} "
                f"max_fanin={self.max_fanin()}")


class TraceRecorder:
    """Collects :class:`TraceNode` provenance during one simulator run.

    Constructed by the :class:`~repro.core.canary.simulator.Simulator` facade
    when ``SimConfig.trace`` is set; the protocol layers call the ``on_*``
    hooks (guarded by ``sim.trace is not None``, so untraced runs pay one
    attribute load per hook site).

    Covers the in-network strategies (CANARY, STATIC_TREE) for every
    collective flavour. Host-based strategies (RING) bypass the hooked paths
    entirely and record nothing.
    """

    def __init__(self, sim):
        self.sim = sim
        self.nodes: List[TraceNode] = []
        # (app, block, gen) -> leader/static-root node id
        self._roots: Dict[Tuple[int, int, int], int] = {}
        # (app, block) -> (root node id, generation) of the completed reduction
        self.completed: Dict[Tuple[int, int], Tuple[int, int]] = {}
        # (app, block) -> hosts the reduced value was delivered to
        self.delivered: Dict[Tuple[int, int], Set[int]] = {}
        # broadcast fan-outs: (app, block) -> [(switch, ports, t)]
        self.bcast_fanouts: Dict[Tuple[int, int],
                                 List[Tuple[int, Tuple[int, ...], float]]] = {}
        # restoration fan-outs: (app, block) -> [(switch, ports)]
        self.restores: Dict[Tuple[int, int],
                            List[Tuple[int, Tuple[int, ...]]]] = {}
        # event counters (trace-local; SimResult counters are untouched)
        self.collisions = 0
        self.stragglers = 0
        self.timeout_flushes = 0
        self.complete_flushes = 0
        # block_tree memo — a completed generation's subtree never mutates
        # (the leader/root stops merging once complete), so reconstruction
        # is cacheable; keyed on the completed root so a later generation
        # completing the same block invalidates naturally
        self._tree_cache: Dict[Tuple[int, int, int], BlockTree] = {}

    # ------------------------------------------------------------ node mgmt
    def _new_node(self, kind: str, where: int, pid: int) -> TraceNode:
        node = TraceNode(node_id=len(self.nodes), kind=kind, where=where,
                         pid=pid, t_start=self.sim.now)
        self.nodes.append(node)
        return node

    def _node_of_packet(self, pkt) -> TraceNode:
        if pkt.trace_node < 0:
            # Defensive: a REDUCE packet from an unhooked creation site.
            # Synthesize a leaf so the tree stays connected (src < 0 would
            # mean a switch-made packet — those are always tagged on flush).
            node = self._new_node(HOST_SEND, pkt.src, pkt.id)
            if pkt.src >= 0:
                node.contribs[pkt.src] += 1
            pkt.trace_node = node.node_id
        return self.nodes[pkt.trace_node]

    def _merge(self, parent: TraceNode, in_port: int, pkt) -> None:
        child = self._node_of_packet(pkt)
        parent.children.append(child.node_id)
        parent.in_ports.append(in_port)
        parent.contribs.update(child.contribs)

    # ------------------------------------------------------ host-side hooks
    def on_host_send(self, host: int, pkt) -> None:
        """A host emitted a REDUCE contribution (first send or a new
        generation after a §3.3 failure round)."""
        node = self._new_node(HOST_SEND, host, pkt.id)
        node.contribs[host] += 1
        pkt.trace_node = node.node_id

    def on_leader_merge(self, host: int, pkt) -> None:
        """The leader accepted a (partial) aggregate for the current
        generation (§3.1.4)."""
        key = (id_app(pkt.id), id_block(pkt.id), id_gen(pkt.id))
        nid = self._roots.get(key)
        if nid is None:
            node = self._new_node(LEADER, host, pkt.id)
            self._roots[key] = node.node_id
        else:
            node = self.nodes[nid]
        self._merge(node, -1, pkt)

    def on_leader_complete(self, host: int, app: int, block: int,
                           gen: int) -> None:
        """The leader's counter reached hosts-1: the reduction of this
        generation is complete. The leader's own contribution never crossed
        the wire (§3.1.4) — attach it as a local leaf."""
        key = (app, block, gen)
        nid = self._roots.get(key)
        if nid is None:  # single-contributor degenerate case
            node = self._new_node(LEADER, host, make_id(app, block, gen))
            self._roots[key] = nid = node.node_id
        node = self.nodes[nid]
        if self.sim.strategy.leader_skips_self:
            self_leaf = self._new_node(HOST_SEND, host,
                                       make_id(app, block, gen))
            self_leaf.contribs[host] += 1
            node.children.append(self_leaf.node_id)
            node.in_ports.append(-1)
            node.contribs.update(self_leaf.contribs)
        node.t_flush = self.sim.now
        self.completed[(app, block)] = (node.node_id, gen)

    def on_host_complete(self, host: int, app: int, block: int) -> None:
        self.delivered.setdefault((app, block), set()).add(host)

    def on_restore(self, pid: int, sw: int, ports: Tuple[int, ...]) -> None:
        self.restores.setdefault(block_key(pid), []).append((sw, ports))

    # ---------------------------------------------------- switch-side hooks
    def on_desc_alloc(self, sw: int, desc, in_port: int, pkt) -> None:
        node = self._new_node(SWITCH_DESC, sw, pkt.id)
        desc.trace_node = node.node_id
        self._merge(node, in_port, pkt)

    def on_switch_merge(self, sw: int, desc, in_port: int, pkt) -> None:
        if desc.trace_node < 0:  # descriptor allocated before tracing began
            node = self._new_node(SWITCH_DESC, sw, pkt.id)
            desc.trace_node = node.node_id
        self._merge(self.nodes[desc.trace_node], in_port, pkt)

    def on_desc_flush(self, sw: int, desc, out_pkt, reason: str) -> None:
        """The descriptor forwarded its aggregate (timeout or complete);
        from here on the outgoing packet *is* this node."""
        if desc.trace_node < 0:
            node = self._new_node(SWITCH_DESC, sw, desc.id)
            desc.trace_node = node.node_id
        node = self.nodes[desc.trace_node]
        node.flush_reason = reason
        node.t_flush = self.sim.now
        out_pkt.trace_node = node.node_id
        if reason == FLUSH_TIMEOUT:
            self.timeout_flushes += 1
        else:
            self.complete_flushes += 1

    def on_static_root_done(self, sw: int, desc) -> None:
        """STATIC_TREE: the root switch completed the reduction — it is the
        tree root (there is no leader-host aggregation)."""
        if desc.trace_node < 0:
            return
        node = self.nodes[desc.trace_node]
        node.kind = STATIC_ROOT
        node.t_flush = self.sim.now
        key = (node.app, node.block)
        self.completed[key] = (node.node_id, node.gen)

    def on_collision(self, sw: int, in_port: int, pkt) -> None:
        self.collisions += 1

    def on_straggler(self, sw: int, in_port: int, pkt) -> None:
        # The descriptor already fired: the packet continues to the leader
        # unmerged, so its edge is recorded there, not here (§3.1.1). The
        # broadcast still fans out to this port via desc.children.
        self.stragglers += 1

    def on_bcast_fanout(self, sw: int, pkt, ports) -> None:
        self.bcast_fanouts.setdefault(block_key(pkt.id), []).append(
            (sw, tuple(sorted(ports)), self.sim.now))

    # ------------------------------------------------------------- analysis
    def block_keys(self) -> List[Tuple[int, int]]:
        return sorted(self.completed)

    def block_tree(self, app: int, block: int) -> BlockTree:
        """Reconstruct the completed reduction tree of ``(app, block)``."""
        try:
            root, gen = self.completed[(app, block)]
        except KeyError:
            raise KeyError(
                f"no completed reduction recorded for app={app} "
                f"block={block} (host-based algorithms are not traced)"
            ) from None
        cached = self._tree_cache.get((app, block, root))
        if cached is not None:
            return cached
        nodes: Dict[int, TraceNode] = {}
        stack = [root]
        while stack:
            nid = stack.pop()
            if nid in nodes:
                continue
            node = self.nodes[nid]
            nodes[nid] = node
            stack.extend(node.children)
        tree = BlockTree(app=app, block=block, gen=gen, root=root,
                         nodes=nodes, participants=sorted(
                             self.sim.partset[app]))
        self._tree_cache[(app, block, root)] = tree
        return tree

    def trees(self, app: int) -> List[BlockTree]:
        return [self.block_tree(a, b) for a, b in self.block_keys()
                if a == app]

    def deepest_tree(self) -> Optional[BlockTree]:
        best: Optional[BlockTree] = None
        best_depth = -1
        for a, b in self.block_keys():
            t = self.block_tree(a, b)
            d = t.depth()
            if d > best_depth:
                best, best_depth = t, d
        return best

    def summary(self) -> str:
        n_blocks = len(self.completed)
        deepest = self.deepest_tree()
        lines = [f"trace: {n_blocks} completed blocks, "
                 f"{len(self.nodes)} nodes, "
                 f"timeout_flushes={self.timeout_flushes} "
                 f"complete_flushes={self.complete_flushes} "
                 f"collisions={self.collisions} stragglers={self.stragglers}"]
        if deepest is not None:
            lines.append(f"deepest tree: {deepest.summary()}")
        return "\n".join(lines)
