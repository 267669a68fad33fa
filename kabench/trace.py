"""The traced window: ``torch.profiler`` over every request of the window,
kept in memory, reduced to device busy time, the device operations that took
most time, and the device's idle time by what the host was doing.

Requests are marked with ``record_function`` from the harness, so their
bounds are read on the profiler's own clock. Inside a request the host's
phase is laid out from the program's phase timers (``Driver.phases``); idle
time outside every request is the harness's own.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "kabench/window"
REQUEST = "kabench/request"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Tracer:
    """``with tracer.window(): ... with tracer.request(): ...``; after the
    window, :meth:`reduce`. A disabled tracer adds nothing."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.prof = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        with self.prof:
            with record_function(WINDOW):
                yield

    def request(self):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(REQUEST)

    def reduce(self, phases: Sequence[Tuple[str, str, List[Tuple[str, float]]]]) -> dict:
        """``phases``: per request, in order, ``(kind, anchor, [(label, ms),
        ...])`` from the driver. Returns ``busy_s``, ``window_s``, ``device_ops`` and
        ``idle_gaps`` (top :data:`TOP` each, as ``[name, seconds]``)."""
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        return reduce_events(events, phases)


def _is_device(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    return str(e.device_type()).endswith("CUDA") and not e.name().startswith("kabench/")


def _on_host(e) -> bool:
    """A host-side event: ``record_function`` also leaves a device-side
    copy of each annotation, spanning its kernels."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return not kind().startswith("gpu")
    return not str(e.device_type()).endswith("CUDA")


def merge(intervals: Sequence[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, sorted."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def layout(bounds: Tuple[int, int], anchor: str, kind: str,
           phases: List[Tuple[str, float]]) -> List[Tuple[int, int, str]]:
    """Phase intervals of one request in profiler ns: laid forward from its
    start (``anchor`` ``start``) or backward from its end (``end``); the
    rest of the request is ``<kind>/other``."""
    lo, hi = bounds
    out = []
    if anchor == "start":
        t = lo
        for name, ms in phases:
            e = min(hi, t + int(ms * 1e6))
            out.append((t, e, f"{kind}/{name}"))
            t = e
    else:
        t = hi
        for name, ms in reversed(phases):
            s = max(lo, t - int(ms * 1e6))
            out.append((s, t, f"{kind}/{name}"))
            t = s
    return out


def timeline(lo: int, hi: int, requests: List[Tuple[int, int]],
             phases) -> List[Tuple[int, int, str]]:
    """``[lo, hi]`` cut into labelled, ordered segments: each request's
    phases, the rest of a request as ``<kind>/other``, and the time between
    requests as the harness's."""
    out: List[Tuple[int, int, str]] = []
    t = lo
    for (s, e), (kind, anchor, ph) in zip(requests, phases):
        if s > t:
            out.append((t, s, "harness/between_requests"))
        cur = s
        for ps, pe, name in sorted(layout((s, e), anchor, kind, ph)):
            if ps > cur:
                out.append((cur, ps, f"{kind}/other"))
            if pe > ps:
                out.append((ps, pe, name))
            cur = max(cur, pe)
        if e > cur:
            out.append((cur, e, f"{kind}/other"))
        t = max(t, e)
    if hi > t:
        out.append((t, hi, "harness/between_requests"))
    return out


def reduce_events(events, phases) -> dict:
    window: Optional[Tuple[int, int]] = None
    requests: List[Tuple[int, int]] = []
    device: List[Tuple[int, int]] = []
    by_name: Dict[str, float] = {}
    for e in events:
        name = e.name()
        if _is_device(e):
            s, d = e.start_ns(), e.duration_ns()
            device.append((s, s + d))
            by_name[name] = by_name.get(name, 0.0) + d * 1e-9
        elif name == REQUEST and _on_host(e):
            requests.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name == WINDOW and _on_host(e):
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
    if window is None:
        raise RuntimeError("the traced window's annotation is missing from the trace")
    lo, hi = window
    busy = merge(device, lo, hi)
    requests.sort()
    idle_spans, t = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > t:
            idle_spans.append((t, s))
        t = max(t, e)
    # Idle time by what the host was doing: the idle spans cut by the
    # labelled timeline, both ordered.
    idle: Dict[str, float] = {}
    segs = timeline(lo, hi, requests, phases)
    k = 0
    for a, b in idle_spans:
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < b:
            s, e, name = segs[j]
            part = min(b, e) - max(a, s)
            if part > 0:
                idle[name] = idle.get(name, 0.0) + part * 1e-9
            j += 1

    def top(d):
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "window_s": (hi - lo) * 1e-9,
        "device_ops": top(by_name),
        "idle_gaps": top(idle),
        "requests": len(requests),
    }
