"""``obs`` — the observability layer, the port of the reference's
``kafka_assigner_tpu/obs``:

- **tracing spans** (:mod:`.trace`): hierarchical, wall-clock,
  failure-aware timing of host phases, collected per captured run;
- **metrics registry** (:mod:`.metrics`): counters, gauges, histograms;
- **run reports** (:mod:`.report`): one schema-versioned JSON artifact per
  CLI run (``--report-json PATH`` / ``KA_OBS_REPORT``) plus a summary on
  stderr;
- **device traces** (:mod:`.profile`): ``torch.profiler`` around each
  batched solve dispatch under ``KA_OBS_PROFILE_DIR``;
- the **flight recorder** (:mod:`.flight`).

Disabled (no capture active), a span is a shared no-op singleton and a
metric call one ``None`` check: no files, byte-identical output.
``obs/health.py`` holds the synthetic traffic series.
"""
from __future__ import annotations

from . import flight
from .metrics import (
    counter_add,
    cumulative,
    disable_cumulative,
    enable_cumulative,
    gauge_set,
    hist_ms,
    hist_observe,
    obs_active,
)
from .profile import device_trace, dispatch_trace
from .report import (
    REPORT_SCHEMA_VERSION,
    AccessLog,
    build_report,
    emit_report,
    validate_report,
)
from .trace import RunCollector, active_run, run_capture, span

__all__ = [
    "REPORT_SCHEMA_VERSION",
    "AccessLog",
    "RunCollector",
    "active_run",
    "build_report",
    "counter_add",
    "cumulative",
    "device_trace",
    "disable_cumulative",
    "dispatch_trace",
    "emit_report",
    "enable_cumulative",
    "flight",
    "gauge_set",
    "hist_ms",
    "hist_observe",
    "obs_active",
    "run_capture",
    "span",
    "validate_report",
]
