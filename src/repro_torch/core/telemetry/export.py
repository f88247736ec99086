"""Exporters for the telemetry hub: Perfetto trace JSON + flat time series.

Two wire formats (ARCHITECTURE.md §Telemetry):

* **Perfetto / Chrome trace-event JSON** (:func:`to_perfetto`): load the
  file in https://ui.perfetto.dev. Spans become async ``"b"``/``"e"``
  event pairs (they overlap freely — descriptor windows on one switch do),
  instants become ``"i"`` events, and every time series becomes a ``"C"``
  counter track. Tracks are grouped into synthetic processes: apps,
  switches, hosts, fabric. Timestamps are microseconds (the trace-event
  unit); sub-ns precision survives as fractional ts.
* **Flat series dump** (:func:`write_series_csv` / ``write_series_json``):
  one ``series,t_ns,value`` row per recorded sample, for pandas/gnuplot.

:func:`validate_perfetto` is the schema check CI runs against the emitted
JSON — it returns a list of human-readable violations (empty = valid).
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List, Tuple

__all__ = ["to_perfetto", "write_perfetto", "series_rows",
           "write_series_csv", "write_series_json", "validate_perfetto",
           "to_dump", "write_dump", "DUMP_VERSION", "run_headline_cell"]

# synthetic Perfetto processes, one per track kind
_PIDS = {"app": 1, "sw": 2, "host": 3, "net": 4}
_PROC_NAMES = {1: "apps (block lifecycle)", 2: "switches (descriptors)",
               3: "hosts (transport)", 4: "fabric (drops + counters)"}
# counter series are attached to a process by name prefix
_SERIES_PID = (("link/", 4), ("net/", 4), ("switch/", 2), ("host/", 3),
               ("tp/", 3), ("app/", 1))


def _series_pid(name: str) -> int:
    for prefix, pid in _SERIES_PID:
        if name.startswith(prefix):
            return pid
    return 4


def to_perfetto(tel) -> Dict[str, object]:
    """Render a :class:`~repro.core.telemetry.hub.Telemetry` hub as a
    Chrome trace-event document (``{"traceEvents": [...]}``)."""
    ev: List[dict] = []
    tracks = set()
    for pid, pname in _PROC_NAMES.items():
        ev.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                   "args": {"name": pname}})
    span_id = 0

    def _span(cat, track, tid, name, t0, t1, args=None):
        nonlocal span_id
        span_id += 1
        pid = _PIDS[track]
        tracks.add((pid, tid, track))
        b = {"ph": "b", "cat": cat, "id": span_id, "pid": pid, "tid": tid,
             "ts": t0 / 1e3, "name": name}
        if args:
            b["args"] = args
        ev.append(b)
        ev.append({"ph": "e", "cat": cat, "id": span_id, "pid": pid,
                   "tid": tid, "ts": t1 / 1e3, "name": name})

    def _instant(cat, track, tid, name, t, args=None):
        pid = _PIDS[track]
        tracks.add((pid, tid, track))
        e = {"ph": "i", "cat": cat, "pid": pid, "tid": tid, "ts": t / 1e3,
             "name": name, "s": "t"}
        if args:
            e["args"] = args
        ev.append(e)

    # render the hub's raw tuples (shapes documented in hub.py) — all string
    # formatting happens here, off the simulation hot path
    for s in tel.spans:
        kind = s[0]
        if kind == "block":
            _, app, block, t0, t1, last_host = s
            _span("block", "app", app, f"block {block}", t0, t1,
                  {"app": app, "block": block, "last_host": last_host})
        elif kind == "bcast":
            _, app, block, t0, t1 = s
            _span("bcast", "app", app, f"bcast {block}", t0, t1,
                  {"app": app, "block": block})
        else:  # ("desc", sw, app, block, reason, merges, children, t0, t1)
            _, sw, app, block, reason, merges, children, t0, t1 = s
            _span("desc", "sw", sw, f"desc a{app}/b{block}", t0, t1,
                  {"reason": reason, "merges": merges, "children": children})
    for s in tel.instants:
        kind = s[0]
        if kind == "leader_done":
            _, app, block, leader, t = s
            _instant("block", "app", app, f"leader_done b{block}", t,
                     {"leader": leader})
        elif kind in ("collision", "straggler"):
            _, sw, app, block, t = s
            _instant("switch", "sw", sw, f"{kind} a{app}/b{block}", t,
                     {"app": app, "block": block})
        elif kind == "drop":
            _, cause, where, t = s
            _instant("drop", "net", 0, f"drop {cause}", t, {"where": where})
        elif kind == "retx":
            _, what, app, host, block, t = s
            _instant("retx", "app", app, f"retx {what} b{block}", t,
                     {"host": host})
        elif kind == "cnp":
            _, dst, src, t = s
            _instant("tp", "host", dst, "cnp", t, {"from": src})
        elif kind == "pfc":
            _, host, paused, t = s
            _instant("tp", "host", host,
                     "pfc_pause" if paused else "pfc_resume", t)
        else:  # ("gbn", what, host, count, t)
            _, what, host, count, t = s
            _instant("tp", "host", host, f"gbn_{what}", t, {"count": count})
    for sname, ts in tel.registry.series.items():
        pid = _series_pid(sname)
        for t, v in ts.points():
            ev.append({"ph": "C", "pid": pid, "tid": 0, "ts": t / 1e3,
                       "name": sname, "args": {"value": v}})
    for pid, tid, track in sorted(tracks):
        ev.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                   "args": {"name": f"{track} {tid}"}})
    return {"traceEvents": ev, "displayTimeUnit": "ns",
            "otherData": {"generator": "repro.core.telemetry",
                          "probes": tel.probes,
                          "spans_dropped": tel.spans_dropped}}


def write_perfetto(tel, path: str) -> Dict[str, object]:
    doc = to_perfetto(tel)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


# ---------------------------------------------------------------- flat series
def series_rows(tel) -> Iterator[Tuple[str, float, float]]:
    for name in sorted(tel.registry.series):
        for t, v in tel.registry.series[name].points():
            yield name, t, v


def write_series_csv(tel, path: str) -> int:
    n = 0
    with open(path, "w") as f:
        f.write("series,t_ns,value\n")
        for name, t, v in series_rows(tel):
            f.write(f"{name},{t!r},{v!r}\n")
            n += 1
    return n


def write_series_json(tel, path: str) -> int:
    doc = {name: {"t_ns": list(ts.t), "value": list(ts.v),
                  "hi": ts.hi, "lo": ts.lo, "dropped": ts.dropped}
           for name, ts in sorted(tel.registry.series.items())}
    with open(path, "w") as f:
        json.dump(doc, f)
    return sum(len(s["t_ns"]) for s in doc.values())


# --------------------------------------------------------- full-fidelity dump
DUMP_VERSION = 1


def to_dump(tel) -> Dict[str, object]:
    """Full-fidelity telemetry dump: everything the post-run diagnosis layer
    (``analysis.load_dump`` / ``scripts/diagnose.py``) needs, as one
    strict-JSON document — raw span/instant tuples, every probe series,
    counters, histograms, run metadata and the truncation state that a
    diagnosis must surface. Unlike :func:`to_perfetto` this is lossless:
    ``analysis.load_dump(to_dump(tel))`` and ``analysis.view_of(tel)``
    produce identical views (pinned by ``tests/core/test_diagnosis.py``)."""
    import dataclasses
    reg = tel.registry
    return {
        "version": DUMP_VERSION,
        "cfg": dataclasses.asdict(tel.cfg),
        "meta": getattr(tel, "meta", {}) or {},
        "summary": tel.summary_dict(),
        "truncation": tel.truncation_dict(),
        "spans": [list(s) for s in tel.spans],
        "instants": [list(s) for s in tel.instants],
        "open_blocks": [list(b) for b in getattr(tel, "open_blocks", [])],
        "counters": dict(reg.counters),
        "series": {name: {"t": list(ts.t), "v": list(ts.v),
                          # empty series carry +-inf extrema sentinels,
                          # which strict JSON cannot represent
                          "hi": ts.hi if ts.t else 0.0,
                          "lo": ts.lo if ts.t else 0.0,
                          "dropped": ts.dropped}
                   for name, ts in sorted(reg.series.items())},
        "hists": {name: h.to_dict()
                  for name, h in sorted(reg.hists.items())},
    }


def write_dump(tel, path: str) -> Dict[str, object]:
    doc = to_dump(tel)
    with open(path, "w") as f:
        json.dump(doc, f, allow_nan=False)
    return doc


# ------------------------------------------------------------------ validator
_PHASES = {"b", "e", "i", "C", "M", "X"}


def validate_perfetto(doc) -> List[str]:
    """Schema check for the trace-event JSON. Returns a list of violations
    (empty list = the document is loadable by ui.perfetto.dev)."""
    errs: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document must be a dict with a 'traceEvents' list"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    open_async: Dict[Tuple, int] = {}
    for i, e in enumerate(events):
        where = f"event {i}"
        if not isinstance(e, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _PHASES:
            errs.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str):
            errs.append(f"{where}: missing name")
        if not isinstance(e.get("pid"), int) or not isinstance(
                e.get("tid"), int):
            errs.append(f"{where}: pid/tid must be ints")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)):
                errs.append(f"{where}: ph {ph!r} needs a numeric ts")
        if ph in ("b", "e"):
            if "id" not in e or not isinstance(e.get("cat"), str):
                errs.append(f"{where}: async event needs id + cat")
            else:
                key = (e["cat"], e["id"])
                open_async[key] = open_async.get(key, 0) + (
                    1 if ph == "b" else -1)
        elif ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                errs.append(f"{where}: counter args must be numeric")
        elif ph == "X" and not isinstance(e.get("dur"), (int, float)):
            errs.append(f"{where}: complete event needs dur")
    for key, n in open_async.items():
        if n != 0:
            errs.append(f"async span {key} unbalanced (b-e = {n})")
    return errs


# ------------------------------------------------------------- headline cell
def run_headline_cell(scale: int = 8, data_bytes: int = 1 << 20,
                      seed: int = 3, background: bool = True,
                      **cfg_overrides):
    """Run the headline congested fat-tree cell with telemetry on: half the
    hosts allreduce under CANARY while the other half blasts background
    congestion traffic (disable with ``background=False`` for scenarios
    that need the injected bottleneck isolated), with sender-side noise so
    descriptor windows actually expire (timeout flushes). Returns the
    finished ``Simulator`` (telemetry hub at ``sim.telemetry``, result at
    ``sim.telemetry_result``).
    """
    from ..canary import Algo, AllreduceJob, Simulator, scaled_config
    base = dict(seed=seed, noise_prob=0.05, telemetry=True)
    base.update(cfg_overrides)
    cfg = scaled_config(scale, **base)
    n = cfg.num_hosts
    sim = Simulator(cfg, [AllreduceJob(0, list(range(n // 2)), data_bytes)],
                    algo=Algo.CANARY,
                    noise_hosts=list(range(n // 2, n)) if background else [])
    sim.telemetry_result = sim.run()
    return sim
