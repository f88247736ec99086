"""String-keyed metrics primitives for the telemetry hub.

Three metric families plus a time-series container, all deliberately dumb:

* **Counters** — monotonically increasing floats (``inc``).
* **Gauges** — last-value / high-water floats (``gauge_set`` / ``gauge_max``).
  High-water gauges are updated at the *event* that moves the value (e.g.
  descriptor allocation), so their maxima are exact even when the periodic
  probe cadence is too coarse to catch a transient peak.
* **Histograms** — power-of-two-bucketed distributions (``observe``) with
  exact count/sum/min/max, for latency-shaped values (block completion
  times, descriptor aggregation windows).
* **TimeSeries** — delta-encoded ``(t, value)`` samples: a record only
  appends when the value changed, so an idle link's backlog series is one
  point, not one per probe. Each series carries a hard sample cap; overflow
  increments ``dropped`` (never silent) while min/max stay exact.

Everything here is plain Python with no simulator imports, so the registry
is reusable by the fleet driver and the exporters, and the whole package
stays jax-free.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

__all__ = ["Counter", "Histogram", "TimeSeries", "MetricsRegistry"]


class Histogram:
    """Power-of-two-bucketed distribution of non-negative values.

    Bucket ``i`` counts values ``v`` with ``2**(i-1) < v <= 2**i`` (bucket 0
    takes ``v <= 1``), i.e. the bucket index is the binary exponent of the
    value — cheap, unbounded-range, and good enough for latency shapes.
    """

    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 1.0:
            i = 0
        else:
            # frexp(v) = (m, e) with 0.5 <= m < 1 and v = m * 2**e, so the
            # smallest power of two >= v is 2**e (e-1 when v is exact)
            m, e = math.frexp(v)
            i = e - 1 if m == 0.5 else e
        self.buckets[i] = self.buckets.get(i, 0) + 1

    def observe_many(self, values: List[float]) -> None:
        """Bulk ``observe``: one call replaying a whole value list, with the
        loop state held in locals. ``finish()`` replays the raw latency and
        aggregation-window lists through this — at small scales the replay
        is a measurable slice of the whole telemetry budget, and the
        per-call interpreter overhead of N ``observe`` calls dominates the
        arithmetic."""
        if not values:
            return
        frexp = math.frexp
        buckets = self.buckets
        get = buckets.get
        n = 0
        s = 0.0
        lo = self.min
        hi = self.max
        for v in values:
            n += 1
            s += v
            if v < lo:
                lo = v
            if v > hi:
                hi = v
            if v <= 1.0:
                i = 0
            else:
                m, e = frexp(v)
                i = e - 1 if m == 0.5 else e
            buckets[i] = get(i, 0) + 1
        self.count += n
        self.sum += s
        self.min = lo
        self.max = hi

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_dict(self) -> Dict[str, object]:
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "mean": self.mean,
                "buckets": {str(k): v for k, v in sorted(self.buckets.items())}}


class TimeSeries:
    """Delta-encoded ``(t, value)`` samples with a hard cap.

    ``record`` is the hot call: it appends only when the value differs from
    the last recorded one. ``hi``/``lo`` track the exact extrema across every
    *offered* sample, so a capped series still reports true high-waters.
    """

    __slots__ = ("t", "v", "last", "hi", "lo", "dropped", "_cap")

    def __init__(self, cap: int = 200_000) -> None:
        self.t: List[float] = []
        self.v: List[float] = []
        self.last: float = math.nan  # nan != anything, so the 1st sample lands
        self.hi = -math.inf
        self.lo = math.inf
        self.dropped = 0
        self._cap = cap

    def record(self, t: float, value: float) -> None:
        if value != self.last:
            if value > self.hi:
                self.hi = value
            if value < self.lo:
                self.lo = value
            if len(self.t) < self._cap:
                self.t.append(t)
                self.v.append(value)
            else:
                self.dropped += 1
            self.last = value

    def __len__(self) -> int:
        return len(self.t)

    def points(self) -> Iterator[Tuple[float, float]]:
        return zip(self.t, self.v)


class Counter(float):
    """Marker type alias — counters live as plain floats in the registry."""


class MetricsRegistry:
    """Flat, string-keyed store of counters, gauges, histograms and series.

    Naming convention (used by probes, hooks and exporters alike):
    ``<scope>/<id>/<metric>`` — e.g. ``link/12/backlog_bytes``,
    ``switch/3/descriptors``, ``host/40/rate_gbps``, ``app/0/blocks_left``.
    Aggregates drop the id: ``net/backlog_max_bytes``.
    """

    __slots__ = ("counters", "gauges", "hists", "series", "_series_cap")

    def __init__(self, series_cap: int = 200_000) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Histogram] = {}
        self.series: Dict[str, TimeSeries] = {}
        self._series_cap = series_cap

    # -- counters -----------------------------------------------------------
    def inc(self, name: str, delta: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + delta

    # -- gauges -------------------------------------------------------------
    def gauge_set(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def gauge_max(self, name: str, value: float) -> None:
        if value > self.gauges.get(name, -math.inf):
            self.gauges[name] = value

    # -- histograms ---------------------------------------------------------
    def hist(self, name: str) -> Histogram:
        """Resolve (creating if needed) a histogram — callers with a hot
        observe path keep the returned object instead of re-looking it up."""
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram()
        return h

    def observe(self, name: str, value: float) -> None:
        self.hist(name).observe(value)

    # -- time series ---------------------------------------------------------
    def ts(self, name: str) -> TimeSeries:
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = TimeSeries(self._series_cap)
        return s

    def record(self, name: str, t: float, value: float) -> None:
        self.ts(name).record(t, value)

    # -- digests --------------------------------------------------------------
    def total_samples(self) -> int:
        return sum(len(s) for s in self.series.values())

    def samples_dropped(self) -> int:
        return sum(s.dropped for s in self.series.values())
