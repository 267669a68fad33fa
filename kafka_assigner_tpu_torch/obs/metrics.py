"""Metric write API: counters, gauges, histograms on the active run — the
port of the reference's ``kafka_assigner_tpu/obs/metrics.py``, same names,
default edges and semantics.

Every function here is a no-op costing one attribute read and one ``None``
check when no run is captured (``obs/trace.py``). Names are dotted,
lowercase and stable: they are the run report's public surface, declared
in ``obs/names.py``:

- ``zk.*``      metadata reads and bytes (the snapshot backend counts here,
  as every reference backend does);
- ``ingest.*``  topics read and skipped under best-effort;
- ``encode.*``  the batched host encode (pad waste, group shape);
- ``plan.*``    gauges lifted into the report's ``plan`` section;
- ``whatif.*``  scenario-sweep fan-out and dispatch times;
- ``groups.*``  consumer-group plans, sweeps, dispatches and fallbacks;
- ``greedy.*`` / ``native.*`` / ``solver.*`` / ``solve.*``  per-lane solve
  counters and the best-effort fallbacks;
- ``faults.*``  injected faults (``faults.injected.<kind>`` composes).

Histogram bucket upper edges come from ``KA_OBS_HIST_EDGES`` (ms for
timing histograms); one shared edge set keeps reports comparable.

:class:`CumulativeMetrics` is the process-lifetime registry a resident
process installs with :func:`enable_cumulative`; every write through this
module then also lands there. The one-shot CLI never enables it.
"""
from __future__ import annotations

import math
import sys
import threading
import time
from typing import Dict, Optional, Tuple

from . import trace

#: Default histogram bucket upper edges (last bucket is the overflow).
DEFAULT_HIST_EDGES: Tuple[float, ...] = (
    1.0, 5.0, 25.0, 100.0, 500.0, 2500.0, 10000.0
)

#: One label tuple: (("cluster", "west"),) — sorted (key, value) pairs.
Labels = Tuple[Tuple[str, str], ...]


def _split_label(name: str) -> Tuple[str, Labels]:
    """``daemon.requests@west`` → (``daemon.requests``, cluster=west); plain
    names carry no labels."""
    if "@" in name:
        base, _, cluster = name.rpartition("@")
        if base:
            return base, (("cluster", cluster),)
    return name, ()


class CumulativeMetrics:
    """Process-lifetime counters/gauges/histograms, keyed by (name, labels).
    Thread-safe: one lock."""

    def __init__(self, hist_edges: Tuple[float, ...] = ()) -> None:
        self.hist_edges: Tuple[float, ...] = tuple(hist_edges)
        self.started_at = time.time()
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Labels], int] = {}
        self._gauges: Dict[Tuple[str, Labels], float] = {}
        self._hists: Dict[Tuple[str, Labels], dict] = {}

    @staticmethod
    def _key(name: str, labels: Optional[Dict[str, str]]) -> Tuple[str, Labels]:
        if labels:
            return name, tuple(sorted(
                (str(k), str(v)) for k, v in labels.items()
            ))
        return _split_label(name)

    def counter_add(self, name: str, n: int = 1,
                    labels: Optional[Dict[str, str]] = None) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + int(n)

    def gauge_set(self, name: str, value,
                  labels: Optional[Dict[str, str]] = None) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._gauges[key] = value

    def hist_observe(self, name: str, value: float,
                     labels: Optional[Dict[str, str]] = None) -> None:
        key = self._key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                edges = list(self.hist_edges)
                h = self._hists[key] = {
                    "edges": edges,
                    "counts": [0] * (len(edges) + 1),
                    "count": 0,
                    "sum": 0.0,
                }
            i = 0
            edges = h["edges"]
            while i < len(edges) and value > edges[i]:
                i += 1
            h["counts"][i] += 1
            h["count"] += 1
            h["sum"] = round(h["sum"] + value, 6)

    def counter_value(self, name: str,
                      labels: Optional[Dict[str, str]] = None) -> int:
        with self._lock:
            return self._counters.get(self._key(name, labels), 0)

    def replace_gauges(
        self,
        name: str,
        series: Dict[Tuple[Tuple[str, str], ...], float],
        base_labels: Optional[Dict[str, str]] = None,
    ) -> None:
        """Swap, in one locked step, every series of gauge ``name`` whose
        labels include ``base_labels`` for the given set (each ``series``
        key is a sorted label tuple, merged over ``base_labels``). The
        daemon's per-partition traffic and lag series take this write: a
        deleted topic's series goes with it, and a concurrent scrape never
        sees a family half replaced."""
        base = tuple(sorted(
            (str(k), str(v)) for k, v in (base_labels or {}).items()
        ))
        base_set = set(base)
        with self._lock:
            for key in [
                k for k in self._gauges
                if k[0] == name and base_set <= set(k[1])
            ]:
                del self._gauges[key]
            for labels, value in series.items():
                merged = dict(base)
                merged.update((str(k), str(v)) for k, v in labels)
                self._gauges[(name, tuple(sorted(merged.items())))] = value

    def snapshot(self) -> dict:
        """A structured copy: each section maps ``name → {labels:
        value-or-hist}`` (labels as sorted tuples)."""
        with self._lock:
            out = {"counters": {}, "gauges": {}, "hists": {}}
            for (name, labels), v in self._counters.items():
                out["counters"].setdefault(name, {})[labels] = v
            for (name, labels), v in self._gauges.items():
                out["gauges"].setdefault(name, {})[labels] = v
            for (name, labels), h in self._hists.items():
                out["hists"].setdefault(name, {})[labels] = {
                    "edges": list(h["edges"]),
                    "counts": list(h["counts"]),
                    "count": h["count"],
                    "sum": h["sum"],
                }
            return out


#: The process-lifetime registry, or None (the CLI's state).
_CUMULATIVE: Optional[CumulativeMetrics] = None


def enable_cumulative(hist_edges=None) -> CumulativeMetrics:
    """Install a fresh cumulative registry (tests reset by calling again or
    :func:`disable_cumulative`)."""
    global _CUMULATIVE
    if hist_edges is None:
        hist_edges = resolve_hist_edges()
    _CUMULATIVE = CumulativeMetrics(hist_edges=tuple(hist_edges))
    return _CUMULATIVE


def disable_cumulative() -> None:
    global _CUMULATIVE
    _CUMULATIVE = None


def cumulative() -> Optional[CumulativeMetrics]:
    """The live cumulative registry, or None."""
    return _CUMULATIVE


def obs_active() -> bool:
    """True when a run capture is recording: the gate for metric
    computations that are themselves non-trivial (e.g. plan diff stats)."""
    return trace._current() is not None


def counter_add(name: str, n: int = 1) -> None:
    run = trace._current()
    if run is not None:
        run.counter_add(name, n)
    cum = _CUMULATIVE
    if cum is not None:
        cum.counter_add(name, n)


def gauge_set(name: str, value) -> None:
    run = trace._current()
    if run is not None:
        run.gauge_set(name, value)
    cum = _CUMULATIVE
    if cum is not None:
        cum.gauge_set(name, value)


def hist_observe(name: str, value: float) -> None:
    run = trace._current()
    if run is not None:
        run.hist_observe(name, value)
    cum = _CUMULATIVE
    if cum is not None:
        cum.hist_observe(name, value)


class _HistTimer:
    """Metrics-only timer: observes elapsed ms into a histogram without a
    span record, through :func:`hist_observe`."""

    __slots__ = ("_name", "_t0")

    def __init__(self, name) -> None:
        self._name = name

    def __enter__(self) -> None:
        self._t0 = time.perf_counter()
        return None

    def __exit__(self, *exc) -> bool:
        hist_observe(
            self._name, (time.perf_counter() - self._t0) * 1000.0
        )
        return False


def hist_ms(name: str):
    """Context manager observing the block's wall ms into histogram
    ``name``; the shared no-op singleton when nothing records."""
    if trace._current() is None and _CUMULATIVE is None:
        return trace.NULL_SPAN
    return _HistTimer(name)


def resolve_hist_edges() -> Tuple[float, ...]:
    """Bucket edges from ``KA_OBS_HIST_EDGES`` (comma-separated floats,
    sorted ascending). Malformed values are ignored loudly and the default
    edge set is used."""
    from ..utils.env import env_str

    raw = env_str("KA_OBS_HIST_EDGES")
    if not raw:
        return DEFAULT_HIST_EDGES
    try:
        edges = tuple(sorted(float(t) for t in raw.split(",") if t.strip()))
    except ValueError:
        edges = ()
    # nan/inf break bucketing (`value > nan` is always False), duplicates
    # make unreachable buckets, and non-positive edges are dead buckets for
    # ms values: all malformed, all rejected loudly.
    if not all(
        math.isfinite(e) and e > 0 for e in edges
    ) or len(set(edges)) != len(edges):
        edges = ()
    if not edges:
        print(
            f"kafka-assigner: ignoring malformed KA_OBS_HIST_EDGES={raw!r} "
            "(expected comma-separated distinct positive numbers)",
            file=sys.stderr,
        )
        return DEFAULT_HIST_EDGES
    return edges
