"""Opt-in observability for the discrete-event core (ARCHITECTURE.md
§Telemetry).

Enable with ``SimConfig(telemetry=True)``: the facade hangs a
:class:`~.hub.Telemetry` hub off ``Simulator.telemetry`` and every layer's
hook sites light up behind their ``is not None`` guards. Off (the default)
means *no hub object exists* — the same zero-overhead contract as the trace
recorder and transport policies — and on or off, all goldens replay
bit-identical (probe ticks dispatch outside the pinned ``events`` count).

The package is jax-free and import-light; ``repro.core.canary`` only
imports it lazily when a config asks for telemetry.
"""
from .analysis import (Intervals, RunView, critical_path, hotspots,
                       load_dump, view_of)
from .attribution import (CAUSES, CONSERVATION_REL_TOL, Diagnosis,
                          attribute_app, attribute_block, diagnose)
from .export import (run_headline_cell, series_rows, to_dump, to_perfetto,
                     validate_perfetto, write_dump, write_perfetto,
                     write_series_csv, write_series_json)
from .hub import Telemetry
from .metrics import Histogram, MetricsRegistry, TimeSeries

__all__ = [
    "Telemetry", "MetricsRegistry", "Histogram", "TimeSeries",
    "to_perfetto", "write_perfetto", "validate_perfetto", "series_rows",
    "write_series_csv", "write_series_json", "to_dump", "write_dump",
    "run_headline_cell",
    # diagnosis layer (ARCHITECTURE.md §Diagnosis)
    "Intervals", "RunView", "view_of", "load_dump", "critical_path",
    "hotspots", "CAUSES", "CONSERVATION_REL_TOL", "Diagnosis",
    "attribute_block", "attribute_app", "diagnose",
]
