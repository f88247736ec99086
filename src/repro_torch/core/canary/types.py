"""Core datatypes for the Canary packet-level discrete-event simulator.

This module mirrors the entities of the paper:

* ``Packet`` — the Canary packet format of §4.1 (destination/leader address,
  block ``id``, aggregation ``counter``, participating ``hosts`` count, the
  collision stamp fields ``switch_addr``/``port_stamp``, the ``bypass`` and
  ``multicast`` flags, and the payload ``value``).
* ``Descriptor`` — the per-block switch state of §3.1.1 (accumulator, children
  port set, timer, counter) stored in a static hash-indexed array (§3.2).
* ``SimConfig`` — the simulated world: the two-level fat tree of §5.2
  (32 leaf switches x 64 ports, 32 spines x 32 ports, 100 Gb/s links), packet
  framing from the Tofino prototype of §5.1, and the §5.2 congestion model.

Values carried by packets are Python integers so that every simulation is an
*exact* end-to-end correctness check of the allreduce (integer addition is
associative — any aggregation order must give the same total).
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple


class PacketKind(enum.IntEnum):
    """Kinds of packets flowing through the simulated network."""

    REDUCE = 0       # host/switch partial aggregate flowing toward the leader
    BCAST = 1        # fully-reduced data flowing down the recorded tree
    RESTORE = 2      # leader -> switch tree-restoration packet (§3.2.1)
    RETX_REQ = 3     # host -> leader retransmission request (§3.3)
    FAIL = 4         # leader -> host "reduce this block again" message (§3.3)
    UNICAST_DATA = 5 # leader -> host retransmitted reduced block (§3.3)
    NOISE = 6        # background congestion traffic (random uniform, §5.2)
    RING = 7         # host-based ring allreduce traffic (baseline, §5.2)
    # Transport-policy control traffic (repro.core.transport). Ids >= 8 fall
    # in the switch dataplane's contiguous pass-through range (kind >=
    # RETX_REQ): switches forward them toward ``dest`` untouched.
    CNP = 8          # DCQCN congestion-notification packet (receiver -> sender)
    ACK = 9          # go-back-N cumulative acknowledgement (receiver -> sender)


class _StrEnum(str, enum.Enum):
    """``enum.StrEnum`` backport: members *are* their string values and
    ``str()`` returns the bare value (``enum.StrEnum`` itself is 3.11+; the
    supported floor is Python 3.10)."""

    __str__ = str.__str__
    __format__ = str.__format__


class Algo(_StrEnum):
    """Allreduce algorithms implemented in the simulator (§5.2)."""

    CANARY = "canary"
    STATIC_TREE = "static_tree"   # N static trees (N=1 ~ SHARP/SwitchML/ATP, N>1 ~ PANAMA)
    RING = "ring"                 # bandwidth-optimal host-based ring


class LoadBalancing(_StrEnum):
    """Up-port selection policies at the leaf switches."""

    ECMP = "ecmp"            # hash-based, congestion-oblivious
    ADAPTIVE = "adaptive"    # paper §5.2: default port unless >50% full, then min-queue
    PER_PACKET = "per_packet"  # always pick the least-loaded up-port (DRILL-like)


_PKT_SEQ = 0


@dataclass(slots=True)
class Packet:
    """A Canary packet (§4.1). ``size_bytes`` includes header framing."""

    kind: PacketKind
    dest: int                 # destination host id (the leader for REDUCE)
    id: int                   # unique block id: (app << APP_SHIFT) | (block << GEN_BITS) | gen
    counter: int = 0          # number of already-reduced host contributions
    hosts: int = 0            # number of hosts participating in the reduction
    value: int = 0            # payload (exact integer aggregation check)
    bypass: bool = False      # set after a collision: switches must not process
    multicast: bool = False   # set on broadcast-phase packets
    switch_addr: int = -1     # collision stamp: switch address (§3.2.1)
    port_stamp: int = -1      # collision stamp: in-port at that switch (§3.2.1)
    restore_ports: Tuple[int, ...] = ()  # RESTORE: ports bitmap payload (§3.2.1)
    dest_switch: int = -1     # RESTORE: target switch address
    size_bytes: int = 0
    src: int = -1             # source host (for RETX_REQ / debugging)
    chunk: int = -1           # RING: chunk index
    step: int = -1            # RING: algorithm step
    # Provenance tag set by the trace recorder (repro.core.trace) when
    # SimConfig.trace is on: the TraceNode id whose aggregate this packet
    # carries. Observation-only — never read by the protocol layers.
    trace_node: int = -1
    # Transport-policy fields (repro.core.transport). Under the default
    # ``none`` policy both stay at their defaults for a packet's whole life.
    ecn: bool = False         # ECN congestion-experienced mark (dcqcn, RED)
    seq: int = -1             # go-back-N per-flow sequence number (gbn; ACK:
                              # the cumulative acknowledged sequence)


class PacketPool:
    """Free-list allocator for :class:`Packet` (ARCHITECTURE.md §Performance).

    The per-event hot path allocates one ``Packet`` per send; recycling them
    through an explicit free list cuts allocator/GC churn without touching
    simulation semantics. The invariants that keep reuse safe (pinned by the
    golden replays and ``tests/core/test_perf_contract.py``):

    * **Only linear packets are ever freed.** A packet is *linear* when
      exactly one reference exists at any time (REDUCE/NOISE/RING/RESTORE/
      FAIL/UNICAST_DATA/RETX_REQ). Multicast packets (``multicast=True`` —
      broadcast fan-outs schedule the *same object* on several links) must
      never be freed; every free site guards on ``pkt.multicast`` (or frees
      a kind that is never multicast, which also keeps the pooled
      ``multicast`` flag invariantly False).
    * **``free`` resets exactly the fields whose stale values could be
      *read through a guard* on the next life**: ``bypass`` (a stale True
      would route an aggregable REDUCE around every switch), ``switch_addr``
      / ``port_stamp`` (a stale stamp would fabricate §3.2.1 restorations at
      the leader) and ``trace_node`` (the recorder lazily trusts any id
      >= 0). Every other field is only ever read for packet kinds whose
      alloc sites assign it: ``alloc`` sites must set ``kind``, ``dest``,
      ``id``, ``size_bytes`` plus every field their kind's consumers read
      (REDUCE: counter/hosts/value [+src at host sends]; NOISE: src/chunk;
      RING: value/src/chunk/step). RESTORE's ``restore_ports``/
      ``dest_switch`` are exempt because RESTORE packets are always
      constructed fresh, never pool-allocated.
    """

    __slots__ = ("_free", "allocated", "reused", "freed", "max_free")

    def __init__(self, max_free: int = 8192) -> None:
        self._free: List["Packet"] = []
        self.allocated = 0   # fresh Packet constructions
        self.reused = 0      # allocs served from the free list
        self.freed = 0       # packets returned to the pool
        self.max_free = max_free

    def alloc(self) -> "Packet":
        free = self._free
        if free:
            self.reused += 1
            return free.pop()
        self.allocated += 1
        return Packet(kind=PacketKind.REDUCE, dest=-1, id=0)

    def free(self, pkt: "Packet") -> None:
        free = self._free
        if len(free) < self.max_free:
            # minimal reset — see the class docstring for the field audit.
            # ``ecn``/``seq`` join it: a stale ECN mark would fabricate CNPs
            # on the next life, a stale seq would make an unsequenced packet
            # look go-back-N-tracked (both read through ``is not default``
            # guards in repro.core.transport).
            pkt.bypass = False
            pkt.switch_addr = -1
            pkt.port_stamp = -1
            pkt.trace_node = -1
            pkt.ecn = False
            pkt.seq = -1
            self.freed += 1
            free.append(pkt)

    # NOTE: ``freed`` can exceed ``allocated + reused`` — packets born via
    # the plain ``Packet(...)`` constructor (control traffic: FAIL, RESTORE,
    # UNICAST_DATA, RETX_REQ) are recycled into the pool at end-of-life too.


# --- Block id packing -------------------------------------------------------
# id = (app << APP_SHIFT) | (block << GEN_BITS) | generation
# A retransmitted block gets a fresh generation so that it hashes to (likely)
# different descriptor slots and ECMP paths, exactly as §3.3 prescribes
# ("the hosts re-issue the reduction of that packet with a different id").
GEN_BITS = 6
APP_SHIFT = 40
BLOCK_MASK = (1 << (APP_SHIFT - GEN_BITS)) - 1


def make_id(app: int, block: int, generation: int = 0) -> int:
    return (app << APP_SHIFT) | (block << GEN_BITS) | generation


def id_app(pid: int) -> int:
    return pid >> APP_SHIFT


def id_block(pid: int) -> int:
    return (pid >> GEN_BITS) & BLOCK_MASK


def id_gen(pid: int) -> int:
    return pid & ((1 << GEN_BITS) - 1)


def block_key(pid: int) -> Tuple[int, int]:
    """(app, block) — generation-independent identity of a reduction block."""
    return (id_app(pid), id_block(pid))


@dataclass(slots=True)
class Descriptor:
    """Per-block soft state held by a switch (§3.1.1, §3.2).

    Allocated on the first REDUCE packet of a block, deallocated when the
    BCAST sweep passes through (or when garbage-collected after ``gc_ns`` of
    inactivity — stale generations abandoned by a retransmission would
    otherwise leak, a detail the paper leaves to the implementation).
    """

    id: int
    slot: int
    value: int = 0
    counter: int = 0
    hosts: int = 0
    children: Set[int] = field(default_factory=set)
    sent: bool = False            # timer fired (or early completion) — partial forwarded
    expected: int = -1            # STATIC_TREE mode: exact child count to wait for
    alloc_ns: float = 0.0
    last_ns: float = 0.0
    timer_seq: int = 0            # guards against stale timer events
    trace_node: int = -1          # trace recorder tag (see Packet.trace_node)


@dataclass
class SimConfig:
    """World configuration. Defaults reproduce the paper's §5.2 setup."""

    # -- topology --------------------------------------------------------------
    # Which registered Topology implementation to build (see topology.py):
    # "fat_tree" (the paper's 2-level leaf/spine) or "three_tier" (folded-Clos
    # leaf/agg/core). New topologies register via @register_topology.
    topology: str = "fat_tree"
    num_leaves: int = 32
    hosts_per_leaf: int = 32
    num_spines: int = 32              # fat_tree only
    # three_tier only: pods of (num_leaves/num_pods) leaves + aggs_per_pod
    # aggregation switches, num_cores core switches (full bipartite agg<->core)
    num_pods: int = 0
    aggs_per_pod: int = 0
    num_cores: int = 0

    # -- links ---------------------------------------------------------------
    link_gbps: float = 100.0          # hosts and switches: 100 Gb/s NICs/ports
    hop_latency_ns: float = 300.0     # per-hop delay (§3.2.2 cites ~300 ns)
    buffer_bytes: int = 131072        # per output port; 50% threshold for adaptive LB

    # -- packet framing (§5.1: Tofino prototype calibration) ------------------
    payload_bytes: int = 1024         # 256 x 4 B elements (large-sim setting, §5.1)
    header_bytes: int = 57            # 19 B Canary + 14 B Ethernet + 24 B framing

    # -- Canary data plane -----------------------------------------------------
    timeout_ns: float = 1000.0        # descriptor aggregation window (§3.1.1)
    table_size: int = 32768           # descriptor array entries (§5.1: 32K on Tofino)
    partition_table: bool = False     # statically partition table across apps (§3.2.1)
    gc_ns: float = 5e6                # descriptor idle GC (see Descriptor docstring)

    # -- load balancing --------------------------------------------------------
    lb: LoadBalancing = LoadBalancing.ADAPTIVE
    # Background (non-allreduce) traffic policy. The paper's premise (§2.1) is
    # that production traffic load-balanced with ECMP "often experiences
    # congestion, even in the presence of alternative non-congested paths";
    # the congestion-aware substrate is what *Canary* packets ride on. We keep
    # both knobs so the sensitivity is measurable (EXPERIMENTS.md §Sim).
    noise_lb: LoadBalancing = LoadBalancing.ECMP
    lb_threshold: float = 0.5         # occupancy fraction that triggers adaptation
    # CONGA-style path-level congestion metric (up + remote down-link backlog)
    # vs. purely local up-port queues. Canary is "orthogonal to the load
    # balancing algorithm" (§3); CONGA [37] is the paper's canonical example
    # and measures path congestion, so this defaults to True for allreduce
    # traffic. Sensitivity measured in EXPERIMENTS.md §Sim.
    path_aware_lb: bool = True
    # Flowlet switching [37]: point-to-point flows (congestion traffic, ring
    # chunks, unicast control) pick an up-port once per flowlet/message and
    # stick to it; re-decision happens on a new flowlet. Canary's aggregated
    # partials are one packet per (switch, block), i.e. inherently per-packet.
    flowlet_lb: bool = True

    # -- reliability (§3.3) ----------------------------------------------------
    drop_prob: float = 0.0            # iid per-link packet drop probability
    retx_timeout_ns: float = 2.0e5    # ~2 RTT at simulated scale
    max_generations: int = 8          # then fall back to host-based (bypass) reduce
    switch_fail_ns: Optional[float] = None  # time at which `failed_switch` dies
    failed_switch: Optional[int] = None     # global switch index

    # -- host behaviour ---------------------------------------------------------
    noise_prob: float = 0.0           # §5.2.5: P(delay a send by noise_delay_ns)
    noise_delay_ns: float = 1000.0
    noise_msg_bytes: int = 65536      # congestion flows: message size between re-picks
    leader_aggregate_ns: float = 1000.0  # host-side per-block leader processing (§3.2.2 "r")

    # -- transport policy (repro.core.transport) -------------------------------
    # Registry key: "none" (default; bit-identical to the pre-transport
    # engine), "gbn" (go-back-N recovery: per-flow sequence numbers +
    # cumulative ACKs) or "dcqcn" (ECN/RED marking, CNP notification, DCQCN
    # rate control, PFC pause). Knobs are FLAT fields (not a nested
    # dataclass) so sweep work items survive the dataclasses.asdict ->
    # SimConfig(**cfg) round trip.
    transport: str = "none"
    # ECN / RED marking at egress queues (dcqcn): mark probability ramps from
    # 0 at ecn_kmin_bytes of backlog to ecn_pmax at ecn_kmax_bytes, then 1.
    ecn_kmin_bytes: int = 16384
    ecn_kmax_bytes: int = 65536
    ecn_pmax: float = 0.2
    cnp_interval_ns: float = 5.0e4    # min gap between CNPs per (receiver, sender)
    # DCQCN sender state machine (rate decrease on CNP; timer-driven fast
    # recovery then additive increase).
    dcqcn_g: float = 1.0 / 16.0
    dcqcn_rai_gbps: float = 5.0       # additive-increase step
    dcqcn_timer_ns: float = 3.0e5     # rate-increase timer period
    dcqcn_min_rate_gbps: float = 1.0
    dcqcn_f: int = 5                  # fast-recovery stages before additive increase
    # PFC priority pause (dcqcn): pause the culprit sender when an egress
    # queue crosses pfc_pause_bytes; resume when it drains to pfc_resume_bytes.
    pfc_pause_bytes: int = 98304      # Xoff (75% of the default 128 KiB buffer)
    pfc_resume_bytes: int = 32768     # Xon
    # go-back-N (gbn): sender window in packets (point-to-point flows) /
    # blocks (aggregated flows), retransmission timeout, cumulative-ACK cadence.
    gbn_window: int = 32
    gbn_timeout_ns: float = 2.0e5
    gbn_ack_every: int = 1

    # -- experiment ------------------------------------------------------------
    seed: int = 0
    max_events: int = 200_000_000     # safety valve
    # Opt-in aggregation-provenance recording (repro.core.trace): the run
    # gains a ``Simulator.trace`` TraceRecorder that reconstructs the dynamic
    # tree every block actually rode. Recording is observation-only — it
    # touches no RNG draw, schedules no event and mutates no protocol state,
    # so traced runs reproduce untraced ``SimResult``s bit-for-bit.
    trace: bool = False
    # Opt-in telemetry (repro.core.telemetry): a metrics registry, periodic
    # time-series probes sampled on a sim-time cadence, block/descriptor
    # lifecycle spans, and Perfetto / CSV exporters. Observation-only like
    # ``trace``: off means ``Simulator.telemetry is None`` and every hook
    # site reduces to one identity check; on leaves the golden event stream
    # bit-identical (probe ticks dispatch outside the ``events`` count, and
    # no hook touches ``sim.rng`` or protocol state). Knobs are FLAT fields
    # so sweep work items survive the asdict -> SimConfig(**cfg) round trip.
    telemetry: bool = False
    telemetry_probe_ns: float = 10_000.0  # probe cadence in sim time
    telemetry_probes: bool = True         # periodic time-series sampling
    telemetry_spans: bool = True          # lifecycle spans + instant events
    telemetry_max_spans: int = 200_000    # span cap (overflow is counted,
    telemetry_max_samples: int = 200_000  # per-series sample cap  never silent)
    # Per-*packet* instants (stragglers, collisions) get their own, much
    # smaller cap: a congested cell emits tens of thousands, which are
    # worthless individually in a trace view (the exact totals live in
    # ``SimResult``) but dominate the telemetry-on overhead if all retained.
    telemetry_max_pkt_instants: int = 2_000
    # Opt-in fault injection (repro.core.faults): a list of FLAT, JSON-able
    # spec dicts (so sweep work items survive the asdict -> SimConfig(**cfg)
    # round trip), each naming a registered fault kind plus its parameters,
    # e.g. ``{"kind": "switch_crash", "target": 5, "at_ns": 2000.0,
    # "heal_ns": 50000.0}``. Empty means ``Simulator.faults is None`` and
    # every hook site reduces to one identity check — fault-free runs
    # (including every golden) stay bit-identical. Kinds: "switch_crash",
    # "link_down", "link_degrade", "link_flap", "host_slow".
    faults: List[dict] = field(default_factory=list)

    # Derived ------------------------------------------------------------------
    @property
    def num_hosts(self) -> int:
        return self.num_leaves * self.hosts_per_leaf

    @property
    def num_switches(self) -> int:
        """Total switch count of the selected topology (delegates to the
        registered Topology class, so plug-in fabrics report correctly)."""
        from .topology import TOPOLOGIES  # function-level: avoid import cycle
        cls = TOPOLOGIES.get(self.topology)
        if cls is not None:
            return cls.config_num_switches(self)
        if self.topology == "fat_tree":
            # registry not populated yet (bare `types` import): the 2-level
            # formula is correct for the default fabric only
            return self.num_leaves + self.num_spines
        raise ValueError(f"unknown topology {self.topology!r}; import the "
                         "module that registers it before reading num_switches")

    @property
    def bytes_per_ns(self) -> float:
        return self.link_gbps / 8.0  # Gb/s -> B/ns

    @property
    def mtu_bytes(self) -> int:
        return self.payload_bytes + self.header_bytes

    def validate(self) -> None:
        if self.topology == "fat_tree" and self.num_spines > self.hosts_per_leaf:
            # the paper's fat tree is full-bisection: 32 up + 32 down ports/leaf
            raise ValueError("leaf switches need hosts_per_leaf >= num_spines uplinks "
                             "only in oversubscribed setups; got more spines than uplinks")
        if self.payload_bytes <= 0 or self.timeout_ns <= 0:
            raise ValueError("payload_bytes and timeout_ns must be positive")


def paper_config(**overrides) -> "SimConfig":
    """The paper's §5.2 network: 1024 hosts, 32 leaves x 64 ports, 32 spines."""
    base = dict(num_leaves=32, hosts_per_leaf=32, num_spines=32,
                link_gbps=100.0, payload_bytes=1024, table_size=32768)
    base.update(overrides)
    return SimConfig(**base)


def three_tier_config(num_pods: int = 4, leaves_per_pod: int = 2,
                      hosts_per_leaf: int = 4, aggs_per_pod: int = 2,
                      num_cores: int = 4, **overrides) -> "SimConfig":
    """A 3-tier folded-Clos network (leaf/agg/core). Defaults give 32 hosts
    with 2:1 leaf->agg oversubscription; cross-pod paths are 4 switch hops,
    exercising the LB policies twice per packet."""
    base = dict(topology="three_tier",
                num_leaves=num_pods * leaves_per_pod,
                hosts_per_leaf=hosts_per_leaf, num_pods=num_pods,
                aggs_per_pod=aggs_per_pod, num_cores=num_cores,
                table_size=max(4096, num_pods * leaves_per_pod
                               * hosts_per_leaf * 64))
    base.update(overrides)
    return SimConfig(**base)


def scaled_config(scale: int = 8, **overrides) -> "SimConfig":
    """A proportionally scaled-down full-bisection fat tree (scale^2 hosts)
    that keeps the paper's 50%-background-load geometry but runs in seconds
    on CPU. Used by tests and the default benchmark profile."""
    base = dict(num_leaves=scale, hosts_per_leaf=scale, num_spines=scale,
                link_gbps=100.0, payload_bytes=1024,
                table_size=max(4096, scale * scale * 64))
    base.update(overrides)
    return SimConfig(**base)


# Paper-scale parameterizations (1024-4096 hosts). These are the grids the
# flow-level backend (repro.core.flow) exists for: a packet-level cell at
# these sizes costs minutes-to-hours of event dispatch, a flow-level cell is
# one row of a batched XLA call. ``benchmarks/sweep.py --topology <name>``
# accepts any key. Fat trees stay full-bisection (num_spines == up-ports per
# leaf); the folded-Clos entries keep the bench profile's 2:1 leaf->agg
# oversubscription so congestion actually binds.
PAPER_SCALES: Dict[str, Callable[..., "SimConfig"]] = {
    "fat_tree_1024": lambda **o: paper_config(**o),
    "fat_tree_2048": lambda **o: paper_config(
        num_leaves=64, hosts_per_leaf=32, num_spines=32,
        table_size=65536, **o),
    "fat_tree_4096": lambda **o: paper_config(
        num_leaves=64, hosts_per_leaf=64, num_spines=64,
        table_size=131072, **o),
    "three_tier_1024": lambda **o: three_tier_config(
        num_pods=8, leaves_per_pod=4, hosts_per_leaf=32,
        aggs_per_pod=16, num_cores=16, **o),
    "three_tier_2048": lambda **o: three_tier_config(
        num_pods=8, leaves_per_pod=8, hosts_per_leaf=32,
        aggs_per_pod=16, num_cores=32, **o),
    "three_tier_4096": lambda **o: three_tier_config(
        num_pods=16, leaves_per_pod=8, hosts_per_leaf=32,
        aggs_per_pod=16, num_cores=32, **o),
}


def paper_scale_config(name: str, **overrides) -> "SimConfig":
    """Build one of the named 1024-4096-host parameterizations."""
    try:
        factory = PAPER_SCALES[name]
    except KeyError:
        raise KeyError(f"unknown paper-scale topology {name!r} "
                       f"(have: {', '.join(sorted(PAPER_SCALES))})") from None
    return factory(**overrides)


@dataclass
class AllreduceJob:
    """One application's collective over ``participants``.

    ``collective`` (paper §6, "Support for other collectives"):

    * ``allreduce`` — reduce + broadcast (the default).
    * ``reduce``    — the destination (``root``) acts as the leader for every
                      block and the broadcast phase is skipped.
    * ``broadcast`` — the source (``root``) acts as the leader and the
                      aggregation is skipped: receivers send empty *join*
                      packets toward the source (recording the dynamic tree)
                      and the source's data rides the broadcast phase down.
    * ``barrier``   — a 0-byte allreduce (header-only packets).

    ``arrival_ns`` makes the submit time a first-class engine event
    (``EV_JOB_ARRIVE``): the job's protocol state is set up — and its hosts
    start sending — only when the event fires, so fleets of tenants can
    submit jobs open-loop over the lifetime of one run. ``tenant`` groups
    apps under one owner for switch-memory quota accounting
    (``repro.core.fleet``); it defaults to the app id.
    """

    app: int
    participants: List[int]
    data_bytes: int
    collective: str = "allreduce"
    root: Optional[int] = None     # reduce destination / broadcast source
    arrival_ns: float = 0.0        # submit time (0 = present at t=0, as before)
    tenant: int = -1               # owning tenant (< 0: the app is its own tenant)

    def num_blocks(self, payload_bytes: int) -> int:
        if self.collective == "barrier":
            return 1
        return max(1, -(-self.data_bytes // payload_bytes))


@dataclass(frozen=True)
class TenantSpec:
    """A fleet tenant: identity plus its share of the descriptor table.

    ``weight`` drives the weighted quota policies (``repro.core.fleet.quota``):
    a tenant's slot region is ``table_size * weight / sum(weights)``, so a
    priority tenant can claim more of the table (§3.2.2 — descriptor memory
    is the scarce resource bounding concurrent in-network tenants).
    """

    tenant: int
    weight: float = 1.0
    name: str = ""


@dataclass
class SimResult:
    """Outputs of one simulation run."""

    duration_ns: float
    start_ns: float
    # per-app goodput: data_bytes * 8 / duration of that app's allreduce
    goodput_gbps: Dict[int, float]
    correct: bool
    # diagnostics
    link_utilization: List[float]          # one sample per directed link
    avg_utilization: float
    stragglers: int
    collisions: int
    restorations: int
    retransmissions: int
    fallbacks: int
    max_descriptors_per_switch: int
    max_descriptor_bytes: int
    events: int
    dropped_packets: int
    completed_blocks: int
    # -- per-job lifecycle (fleet subsystem) ---------------------------------
    # Additive diagnostics: the golden-replay contract pins only the fields
    # above (tests/core/golden_cases.py GOLDEN_FIELDS).
    job_submit_ns: Dict[int, float] = field(default_factory=dict)
    job_start_ns: Dict[int, float] = field(default_factory=dict)   # admitted/degraded (not deferred)
    job_finish_ns: Dict[int, float] = field(default_factory=dict)
    job_admitted: Dict[int, bool] = field(default_factory=dict)    # False: host-based fallback
    app_fallback_blocks: Dict[int, int] = field(default_factory=dict)
    tenant_of: Dict[int, int] = field(default_factory=dict)
    # -- transport telemetry (repro.core.transport) ---------------------------
    # Additive diagnostics like the fleet fields above. ``drop_causes`` splits
    # the single ``dropped_packets`` total by cause ("wire": iid link loss,
    # "switch_fail": arrivals at a failed switch, "gbn_ooo": go-back-N
    # out-of-order endpoint discards — not part of dropped_packets, which
    # counts in-network losses only). ``transport_stats`` carries the active
    # policy's counters (ecn_marks, cnps, rate_cuts, pfc_pauses,
    # pfc_pause_ns, gbn_retx, gbn_acks, gbn_ooo). ``host_rate_gbps`` is the
    # final DCQCN sending rate of every throttled sender.
    transport: str = "none"
    drop_causes: Dict[str, int] = field(default_factory=dict)
    transport_stats: Dict[str, float] = field(default_factory=dict)
    host_rate_gbps: Dict[int, float] = field(default_factory=dict)
    # -- telemetry (repro.core.telemetry) -------------------------------------
    # Flat numeric digest of the run's Telemetry hub (probe/span/sample
    # counts, backlog and occupancy high-waters, flush split). Deliberately a
    # plain dict of floats — the live hub (with full series and spans) stays
    # on ``Simulator.telemetry``; embedding it here would break the
    # ``dataclasses.asdict`` round trip sweep work items rely on. Empty when
    # telemetry is off.
    telemetry_summary: Dict[str, float] = field(default_factory=dict)
    # -- fault injection (repro.core.faults) ----------------------------------
    # Additive survivability diagnostics, empty when no fault schedule ran.
    # ``fault_events`` logs every injected fault/heal as a flat dict
    # (kind, target, t_ns, phase). ``fault_exposure_ns`` measures, per app,
    # how much of its [start, finish] window overlapped an active fault;
    # ``fault_recovery_ns`` is the tail the app needed after the last
    # overlapping heal (0 when it finished before the heal, or was never
    # exposed). ``survived`` records whether each app completed at all.
    fault_events: List[dict] = field(default_factory=list)
    fault_exposure_ns: Dict[int, float] = field(default_factory=dict)
    fault_recovery_ns: Dict[int, float] = field(default_factory=dict)
    survived: Dict[int, bool] = field(default_factory=dict)

    def jct_ns(self, app: int) -> float:
        """Job completion time: finish minus submit (includes deferral wait)."""
        return self.job_finish_ns[app] - self.job_submit_ns[app]

    def summary(self) -> str:
        gp = ", ".join(f"app{a}={g:.1f}Gbps" for a, g in sorted(self.goodput_gbps.items()))
        # an app with no finish time (deferred, still running, or a budget
        # abort) renders as "done=-", never "done=nan us"
        done = {a: (f"{t/1e3:.1f}us" if t is not None else "-")
                for a in sorted(self.goodput_gbps)
                for t in (self.job_finish_ns.get(a),)}
        apps = " ".join(
            f"app{a}[done={done[a]} fb={self.app_fallback_blocks.get(a, 0)}]"
            for a in sorted(self.goodput_gbps))
        # render EVERY cause present (insertion order), so policy-specific
        # causes like gbn_ooo_discard — and any future ones — never vanish
        dc = self.drop_causes or {"wire": 0, "switch_fail": 0}
        drops = "drops[" + ",".join(f"{k}={v}" for k, v in dc.items()) + "]"
        tseg = ""
        if self.transport != "none":
            ts = self.transport_stats
            tseg = (f" tp={self.transport}"
                    f"[ecn={int(ts.get('ecn_marks', 0))}"
                    f" cnp={int(ts.get('cnps', 0))}"
                    f" pfc={int(ts.get('pfc_pauses', 0))}"
                    f" gbn_retx={int(ts.get('gbn_retx', 0))}"
                    f" ooo={int(ts.get('gbn_ooo', 0))}]")
            if self.host_rate_gbps:
                # senders DCQCN still held below line rate at end of run
                tseg += (f" throttled[{len(self.host_rate_gbps)}hosts"
                         f" min={min(self.host_rate_gbps.values()):.1f}Gbps]")
        return (f"t={self.duration_ns/1e3:.1f}us {gp} correct={self.correct} "
                f"stragglers={self.stragglers} collisions={self.collisions} "
                f"retx={self.retransmissions} maxdesc={self.max_descriptors_per_switch} "
                f"{drops}{tseg} {apps}")
