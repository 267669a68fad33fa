"""Hierarchical tracing spans and the process-wide run collector — the port
of the reference's ``kafka_assigner_tpu/obs/trace.py``, same names and
semantics.

A *span* is one timed, nameable section of host work (``span("encode")``);
spans nest, record wall time, and mark failure status when an exception
unwinds through them. All records land on the active :class:`RunCollector`,
one per captured run, which also owns the metrics registry
(``obs/metrics.py`` writes into it).

Activation is explicit: nothing records until a caller (the CLI, through
``--report-json``, ``KA_OBS_REPORT`` or ``KA_OBS_ENABLE=1``) enters
:func:`run_capture`. With no active run every ``span(...)`` call returns
one shared no-op singleton and every metric call is a single ``None``
check: no allocation, no files, byte-identical output. Spans wrap host
work; a span around device work measures it only where the work ends in a
device synchronize (the solver's phases do).

While a ``torch.profiler`` session records on the calling thread, every
span is also a label, ``ka/<name>``, on the profiler's own clock, around
exactly the interval the span times. A label is a host operator event
(``torch._C._profiler._RecordFunctionFast``), not a ``record_function``
user annotation: an annotation leaves a device-side copy spanning the
kernels it launched, which a trace reader that keys on the device can take
for device activity (``kabench/trace.py`` does where torch's events carry
no activity type, as in torch 2.11).
A session records only the thread that started it, apart from a window
capture (``obs/profile.py:capture_window``), which records every thread and
says so through :func:`labelling_every_thread`. ``report=False`` makes a
span the port's own phase (``obs/names.py:LABEL_NAMES``): its label and its
sink, never the run report, which stays the reference's.
:func:`collector_pauses` times the collector's pauses inside a profiled
block and labels each full collection ``ka/gc``.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

#: Hard cap on recorded spans per run, so a runaway per-partition loop
#: cannot turn the report into a huge artifact. Overflow is counted
#: (``spans_dropped`` in the report).
MAX_SPANS = 4096

#: The prefix of every span's ``torch.profiler`` label.
LABEL_PREFIX = "ka/"


class RunCollector:
    """All observability state for one captured run: the span log (flat,
    start-ordered, parent-indexed) plus the metrics registry (counters,
    gauges, histograms). Metric mutation is lock-guarded; span nesting uses
    one stack and assumes the single orchestration thread the CLI has."""

    def __init__(self, hist_edges: Tuple[float, ...] = ()) -> None:
        self.spans: List[dict] = []
        self.spans_dropped = 0
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, dict] = {}
        self.hist_edges: Tuple[float, ...] = tuple(hist_edges)
        #: Correlation keys stamped into every span recorded after
        #: :meth:`annotate`. Empty for CLI runs, whose span records carry
        #: the core keys only.
        self.annotations: Dict[str, str] = {}
        self._stack: List[tuple] = []  # (span index | None, leaf name)
        self._lock = threading.Lock()

    def annotate(self, key: str, value: str) -> None:
        """Stamp a correlation field (e.g. ``request_id``) into every span
        this run records from now on. Core span keys are protected: an
        annotation never overwrites name/path/ms/status."""
        with self._lock:
            self.annotations[str(key)] = str(value)

    # -- spans (single-threaded: the CLI orchestration thread) -------------

    def _start(self, name: str) -> Optional[int]:
        depth = len(self._stack)
        path = "/".join([n for _, n in self._stack] + [name])
        # Lock-guarded because record_complete (background-thread spans)
        # appends to the same list.
        with self._lock:
            if len(self.spans) >= MAX_SPANS:
                self.spans_dropped += 1
                self._stack.append((None, name))
                return None
            parent = -1
            for idx, _ in reversed(self._stack):
                if idx is not None:
                    parent = idx
                    break
            rec = {
                "name": name,
                "path": path,
                "parent": parent,
                "depth": depth,
                "ms": 0.0,
                "status": "open",
            }
            for k, v in self.annotations.items():
                rec.setdefault(k, v)
            self.spans.append(rec)
            self._stack.append((len(self.spans) - 1, name))
            return len(self.spans) - 1

    def _finish(self, idx: Optional[int], ms: float, ok: bool) -> None:
        if self._stack:
            self._stack.pop()
        if idx is not None:
            rec = self.spans[idx]
            rec["ms"] = round(ms, 3)
            rec["status"] = "ok" if ok else "error"

    def record_complete(self, name: str, ms: float, ok: bool = True) -> None:
        """Record an already-finished span as a root-level record: the
        thread-safe entry for background work, which must never touch the
        orchestration thread's nesting stack. Same cap accounting as live
        spans."""
        with self._lock:
            if len(self.spans) >= MAX_SPANS:
                self.spans_dropped += 1
                return
            rec = {
                "name": name,
                "path": name,
                "parent": -1,
                "depth": 0,
                "ms": round(ms, 3),
                "status": "ok" if ok else "error",
            }
            for k, v in self.annotations.items():
                rec.setdefault(k, v)
            self.spans.append(rec)

    # -- metrics (written through obs/metrics.py) ---------------------------

    def counter_add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def hist_observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                edges = list(self.hist_edges)
                h = self.hists[name] = {
                    "edges": edges,
                    # one bucket per edge (value <= edge) plus overflow
                    "counts": [0] * (len(edges) + 1),
                    "count": 0,
                    "sum": 0.0,
                    "min": None,
                    "max": None,
                }
            i = 0
            edges = h["edges"]
            while i < len(edges) and value > edges[i]:
                i += 1
            h["counts"][i] += 1
            h["count"] += 1
            h["sum"] = round(h["sum"] + value, 6)
            h["min"] = value if h["min"] is None else min(h["min"], value)
            h["max"] = value if h["max"] is None else max(h["max"], value)


class _NullSpan:
    """The shared disabled-mode span: no state, no timing. ``span()`` hands
    the same instance to every caller when nothing records."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def fail(self) -> None:
        pass

    def end(self) -> None:
        pass


NULL_SPAN = _NullSpan()

#: The active collector, or None. Module-global on purpose: span and metric
#: call sites read one attribute and bail, the whole disabled-mode cost.
_ACTIVE: Optional[RunCollector] = None

#: Thread-local capture overlay: a capture bound to one thread shadows the
#: global one for that thread only.
_TLS = threading.local()


def _current() -> Optional[RunCollector]:
    run = getattr(_TLS, "run", None)
    return run if run is not None else _ACTIVE


def active_run() -> Optional[RunCollector]:
    """The collector of the current capture (this thread's local capture
    when one is active, else the process-global one), or None."""
    return _current()


#: True while a ``torch.profiler`` session records every thread of the
#: process (:func:`labelling_every_thread`), where ``torch`` reports the
#: session on the thread that started it only.
_EVERY_THREAD = False


@contextlib.contextmanager
def labelling_every_thread() -> Iterator[None]:
    """Inside the block a profiler session records every thread, so
    :func:`profiling` holds on every thread."""
    global _EVERY_THREAD
    _EVERY_THREAD = True
    try:
        yield
    finally:
        _EVERY_THREAD = False


def profiling() -> bool:
    """Whether a ``torch.profiler`` session records on this thread. torch
    is looked up, never imported: a process without it has no session."""
    torch = sys.modules.get("torch")
    return torch is not None and (_EVERY_THREAD or torch.autograd._profiler_enabled())


def _label(name: str):
    """The label of ``name``, not yet entered: a host operator event. Its
    class is private to torch; a torch without it labels nothing, which
    ``tests/test_torch_tracing.py`` reports."""
    make = getattr(sys.modules["torch"]._C._profiler, "_RecordFunctionFast", None)
    return NULL_SPAN if make is None else make(LABEL_PREFIX + name)


class _Span:
    """One live span: records into the run (when active), under a profiler
    labels its interval ``ka/<name>``, and optionally accumulates its
    elapsed ms into a plain dict ``sink`` (the solver's ``last_timers``,
    which keep working with obs disabled) and/or an obs histogram
    ``hist``."""

    __slots__ = (
        "_run", "_name", "_sink", "_key", "_hist", "_log", "_label", "_t0",
        "_idx", "_failed", "_open",
    )

    def __init__(self, run, name, sink, key, hist, log, label) -> None:
        self._run = run
        self._name = name
        self._sink = sink
        self._key = key
        self._hist = hist
        self._log = log
        self._label = _label(name) if label else None
        self._failed = False
        self._open = False

    def fail(self) -> None:
        """Force error status at exit: for failures signaled by return code
        rather than by an exception (the CLI's nonzero-rc paths), so the
        span log and the report's top-level status never disagree."""
        self._failed = True

    def end(self) -> None:
        """End the span now, inside its ``with`` block, whose exit then
        does nothing: for a phase that ends before the block around it
        does (the what-if sweep's ``prep``)."""
        self.__exit__(None, None, None)

    def __enter__(self) -> "_Span":
        if self._label is not None:
            self._label.__enter__()
        if self._run is not None:
            self._idx = self._run._start(self._name)
        else:
            self._idx = None
        self._open = True
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, etype, evalue, tb) -> bool:
        if not self._open:
            return False
        ms = (time.perf_counter() - self._t0) * 1000.0
        self._open = False
        if self._sink is not None:
            k = self._key if self._key is not None else self._name
            self._sink[k] = self._sink.get(k, 0.0) + ms
        run = self._run
        if run is not None:
            run._finish(self._idx, ms, etype is None and not self._failed)
            if self._hist is not None:
                run.hist_observe(self._hist, ms)
        if self._log is not None:
            # Every phase logs its own elapsed ms at INFO, success or
            # failure, obs capture active or not.
            self._log.info("phase %s: %.2f ms", self._name, ms)
        if self._label is not None:
            self._label.__exit__(etype, evalue, tb)
        return False


def record_span(name: str, ms: float, ok: bool = True) -> None:
    """Record a completed span from any thread (no-op when disabled): the
    background-thread counterpart of :func:`span`."""
    run = _current()
    if run is not None:
        run.record_complete(name, ms, ok)


def span(name: str, *, sink=None, key=None, hist=None, log=None, report=True):
    """A context manager timing one section of host work.

    - active run: records a nested span (wall ms, failure status when an
      exception unwinds through it or ``.fail()`` was called), optionally
      observing the elapsed ms into histogram ``hist``; ``report=False``
      keeps the span out of the run (the port's own phases, declared in
      ``obs/names.py:LABEL_NAMES``);
    - a ``torch.profiler`` session recording on this thread: the label
      ``ka/<name>`` around the span's interval;
    - ``sink``: a plain dict that always accumulates ``sink[key or name] +=
      ms``, run or no run;
    - ``log``: a logger that always gets ``phase <name>: <ms> ms`` at INFO
      on exit, success or failure;
    - none of these: returns the shared no-op singleton.
    """
    run = _current() if report else None
    label = profiling()
    if run is None and sink is None and log is None and not label:
        return NULL_SPAN
    return _Span(run, name, sink, key, hist, log, label)


class _Pauses:
    """A ``gc.callbacks`` entry: the collector's pause time in ms, and the
    label ``ka/gc`` around each full collection while a profiler records
    on the collecting thread."""

    __slots__ = ("ms", "_t0", "_label")

    def __init__(self) -> None:
        self.ms = 0.0
        self._t0 = None
        self._label = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            if info["generation"] == 2 and profiling():
                self._label = _label("gc")
                self._label.__enter__()
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1000.0
            self._t0 = None
            if self._label is not None:
                self._label.__exit__(None, None, None)
                self._label = None


@contextlib.contextmanager
def collector_pauses(sink: dict) -> Iterator[None]:
    """Under a ``torch.profiler`` session on this thread: the collector's
    pause time inside the block, from ``gc.callbacks``, added to
    ``sink["gc"]`` in ms (0.0 when nothing was collected), each full
    collection labelled ``ka/gc``. Pauses of a collection that another
    thread triggers count too: every thread waits for it. Unprofiled,
    nothing is installed and ``sink`` is left alone."""
    if not profiling():
        yield
        return
    pauses = _Pauses()
    gc.callbacks.append(pauses)
    try:
        yield
    finally:
        gc.callbacks.remove(pauses)
        sink["gc"] = sink.get("gc", 0.0) + pauses.ms


@contextlib.contextmanager
def run_capture(hist_edges=None, local: bool = False) -> Iterator[RunCollector]:
    """Activate a fresh :class:`RunCollector` for the duration of the block.

    Captures nest by save/restore (an inner capture shadows, then the outer
    resumes). Histogram bucket edges default to the ``KA_OBS_HIST_EDGES``
    knob. ``local=True`` binds the capture to the calling thread only.
    """
    global _ACTIVE
    if hist_edges is None:
        from .metrics import resolve_hist_edges

        hist_edges = resolve_hist_edges()
    run = RunCollector(hist_edges=tuple(hist_edges))
    if local:
        prev = getattr(_TLS, "run", None)
        _TLS.run = run
        try:
            yield run
        finally:
            _TLS.run = prev
        return
    prev = _ACTIVE
    _ACTIVE = run
    try:
        yield run
    finally:
        _ACTIVE = prev
