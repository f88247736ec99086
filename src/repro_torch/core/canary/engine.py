"""Discrete-event engine: clock, heap and event dispatch.

This is the bottom layer of the simulator stack (see ``ARCHITECTURE.md``):
it knows nothing about networks, switches or collectives — it orders
``(time, seq, kind, a, b, c)`` tuples and hands them to per-kind handlers.
The ``seq`` tiebreaker makes simultaneous events FIFO in push order, which is
what makes whole runs bit-reproducible for the golden-replay tests.

Hot-path notes (see ARCHITECTURE.md §Performance):

* The dispatch loop takes a *pre-resolved handler table* — a sequence
  indexed by event kind, built once per run — and keeps the heaps, the pop
  function and the event counter in locals. ``events`` is written back on
  every exit path so external observers (``SimResult.events``, the golden
  contract) always see the true dispatch count.
* **Split heaps.** Timer-class events (descriptor timers, retransmission
  checks) are pushed far into the future and mostly never fire — they used
  to dominate heap volume, making every pop sift through tens of thousands
  of dormant entries. ``push_timer`` routes them to a second heap; the loop
  pops the global minimum of both tops. Because ``seq`` is a single shared
  counter and ``(t, seq)`` is a total order, the dispatch sequence is
  bit-identical to the single-heap engine — the split only changes *where*
  an entry waits, never *when* it pops.
"""
from __future__ import annotations

import heapq
from typing import Callable, List, Sequence, Tuple

# Event kinds (heap entries are (time, seq, kind, a, b, c) tuples).
EV_ARRIVE_SWITCH = 0  # a=global switch idx, b=in port, c=packet
EV_ARRIVE_HOST = 1    # a=host, c=packet
EV_TIMER = 2          # a=switch, b=timer_seq, c=packet id
EV_PUMP = 3           # a=host
EV_RETX = 4           # a=host, c=(app, block, gen)
EV_FAIL_SWITCH = 5    # a=switch
EV_LEADER_DONE = 6    # a=leader host, c=(app, block, total)
EV_JOB_ARRIVE = 7     # a=app (open-loop job arrival; fleet subsystem)
# Transport-policy events (repro.core.transport). Under the default
# ``transport="none"`` policy none of these is ever pushed, so the golden
# replays see the exact pre-transport event stream. PFC pause/resume are a
# pair: the pause lands one propagation delay after the egress queue crosses
# its high watermark, the resume at the (closed-form) time the queue drains
# to the low watermark.
EV_PFC_PAUSE = 8      # a=host (sender being paused)
EV_PFC_RESUME = 9     # a=host, c=scheduled resume time (supersede guard)
EV_RATE_TIMER = 10    # a=host, c=timer epoch (DCQCN rate-increase timer)
EV_GBN_TIMER = 11     # a=host, c=("p"|"b", flow key, epoch)
# Staged link arrivals (ARCHITECTURE.md §Performance): ``c`` is a *staging
# source* (a Link) whose ``inflight`` deque holds ``(t, seq, packet)``
# entries in FIFO order — one heap entry per busy link instead of one per
# in-flight packet. The loop pops the head packet, re-arms the link's next
# head, and dispatches the same handlers as kinds 0/1 with ``c = packet``.
# These must stay a CONTIGUOUS band above the protocol kinds: the run loop
# detects them with a ``kind >= EV_LINK_ARRIVE_SWITCH`` /
# ``kind <= EV_LINK_ARRIVE_HOST`` compare pair. Renumbering kinds is
# golden-safe — heap order is (t, seq) only; kind never orders events.
EV_LINK_ARRIVE_SWITCH = 12  # a=global switch idx, b=in port, c=Link
EV_LINK_ARRIVE_HOST = 13    # a=host, c=Link
# Telemetry probe (repro.core.telemetry): a periodic observation-only sample
# tick. Dispatched by the loop's third branch WITHOUT incrementing the
# ``events`` counter — the counter is a golden-pinned field, and probes are
# pure observation, so telemetry-on runs report the identical dispatch count
# as telemetry-off runs. Never pushed unless telemetry is enabled.
EV_TELEMETRY_PROBE = 14     # c=Telemetry hub (re-arms itself)
# Fault-injection events (repro.core.faults): scheduled mid-run failures and
# recoveries. Dispatched by the loop's third branch WITHOUT incrementing the
# ``events`` counter — like telemetry probes they are orchestration, not
# protocol traffic, and the counter is a golden-pinned field. Never pushed
# unless ``SimConfig.faults`` is non-empty, so fault-free runs (including
# every golden) see the identical dispatch stream.
EV_FAULT = 15               # a=fault index, c=FaultSchedule
EV_HEAL = 16                # a=fault index, c=FaultSchedule
N_EVENT_KINDS = 17

Handler = Callable[[int, int, object], None]

_Entry = Tuple[float, int, int, int, int, object]


class EventLoop:
    """A monotonic event heap with a stable FIFO tiebreak.

    ``stop`` replaces a per-event ``done()`` callback: the owner sets it
    (synchronously, from inside a handler) when the termination condition
    becomes true, and the loop checks it before every dispatch — the same
    timing a polled predicate had, without a Python call per event.
    """

    __slots__ = ("heap", "timer_heap", "now", "events", "stop", "_seq")

    def __init__(self) -> None:
        self.heap: List[_Entry] = []
        self.timer_heap: List[_Entry] = []
        self.now = 0.0
        self.events = 0
        self.stop = False
        self._seq = 0

    def push(self, t: float, kind: int, a: int, b: int, c: object,
             _heappush=heapq.heappush) -> None:
        self._seq = seq = self._seq + 1
        _heappush(self.heap, (t, seq, kind, a, b, c))

    def push_timer(self, t: float, kind: int, a: int, b: int, c: object,
                   _heappush=heapq.heappush) -> None:
        """Like :meth:`push`, but onto the timer heap — for far-future,
        usually-dormant events (EV_TIMER, EV_RETX). Ordering against ``push``
        events is preserved exactly (shared ``seq``; the run loop pops the
        global minimum of both heaps)."""
        self._seq = seq = self._seq + 1
        _heappush(self.timer_heap, (t, seq, kind, a, b, c))

    def run(self, handlers: Sequence[Handler], max_events: int,
            _heappop=heapq.heappop) -> None:
        """Drain both heaps, dispatching by event kind, until ``stop`` is
        set or both heaps are empty.

        ``handlers`` is a pre-resolved table indexed by event kind (a list or
        tuple of length :data:`N_EVENT_KINDS`). ``max_events`` is a livelock
        safety valve, counted over the whole loop's lifetime (the counter
        survives across ``run`` calls); the budget is checked *before* each
        dispatch, so exactly ``max_events`` events are ever handled.
        """
        handlers = tuple(handlers)
        heap = self.heap
        timers = self.timer_heap
        events = self.events
        _heappush = heapq.heappush
        _LINK = EV_LINK_ARRIVE_SWITCH  # loop-local: no global load per event
        _LINK_HOST = EV_LINK_ARRIVE_HOST
        try:
            while True:
                if heap:
                    src = timers if timers and timers[0] < heap[0] else heap
                elif timers:
                    src = timers
                else:
                    break
                if self.stop:
                    break
                if events >= max_events:
                    raise RuntimeError("event budget exceeded — livelock?")
                t, _, kind, a, b, c = _heappop(src)
                self.now = t
                if kind < _LINK:
                    events += 1
                    handlers[kind](a, b, c)
                elif kind <= _LINK_HOST:
                    events += 1
                    # staged link arrival: deliver the FIFO head, re-arm the
                    # link's next head (its (t, seq) were assigned at
                    # transmit time, so global ordering is preserved)
                    q = c.inflight
                    entry = q.popleft()
                    if q:
                        head = q[0]
                        _heappush(heap, (head[0], head[1], kind, a, b, c))
                    p = entry[2]
                    # ``None`` marks a head neutralized by a link-down fault
                    # drain (repro.core.faults): the slot stays in the deque
                    # because it owns this heap entry, but carries no packet.
                    if p is not None:
                        handlers[kind](a, b, p)
                else:
                    # EV_TELEMETRY_PROBE / EV_FAULT / EV_HEAL: observation
                    # and orchestration, excluded from the golden ``events``
                    # count and the livelock budget
                    handlers[kind](a, b, c)
        finally:
            self.events = events
