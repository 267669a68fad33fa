"""Device-profiler hooks: the op-level view the span log cannot give — the
port of the reference's ``kafka_assigner_tpu/obs/profile.py`` on
``torch.profiler`` in the place of ``jax.profiler``.

Spans record host wall-clock per phase; a ``torch.profiler`` trace records
the host's operators and, once CUDA is initialised in the process, the
card's kernels, copies and sets, each with its start and duration. A trace
is one Chrome trace file (``export_chrome_trace``), readable in Perfetto or
``chrome://tracing``, named uniquely per process and block.

- **per-dispatch tracing** (:func:`dispatch_trace`): gated on
  ``KA_OBS_PROFILE_DIR`` (or the older ``KA_PROFILE``), wraps each batched
  solve dispatch (``assigner.py``) and labels the block
  :data:`DISPATCH_LABEL` with ``torch.profiler.record_function``, so a
  reader finds the dispatch window in the trace. Unset, the default, it
  costs two env reads.
- **window capture** (:func:`capture_window`): one bounded trace of
  whatever the process does for N seconds, on every thread: the request
  threads' and the dispatcher's operators and ``ka/`` span labels
  (``obs/trace.py``).

Both share one non-blocking lock: a dispatch trace that overlaps a window
capture skips tracing (observability is best-effort; a busy profiler never
fails the solve). ``torch`` is imported inside the functions, never when
this module is imported.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
from typing import Iterator, Optional

#: One profiler session per process.
_PROFILER_LOCK = threading.Lock()

#: Window bounds: long enough to catch a solve, short enough that a caller
#: sleeping through the window never wedges for minutes.
MAX_WINDOW_S = 30.0
MIN_WINDOW_S = 0.05

#: The ``record_function`` label around each traced solve dispatch.
DISPATCH_LABEL = "ka/dispatch"

_SEQ = itertools.count()


class ProfilerBusy(RuntimeError):
    """A trace is already being captured; the caller should retry later."""


def profile_dir() -> Optional[str]:
    """The configured trace directory: ``KA_OBS_PROFILE_DIR``, falling back
    to ``KA_PROFILE``; None when profiling is off."""
    from ..utils.env import env_str

    return env_str("KA_OBS_PROFILE_DIR") or env_str("KA_PROFILE")


@contextlib.contextmanager
def device_trace(log_dir: str, what: str = "trace",
                 every_thread: bool = False) -> Iterator[str]:
    """Profile everything in the block and write one Chrome trace into
    ``log_dir`` (created if missing), also when the block raises; yields
    the trace's path. The CPU activity always, the CUDA activity when CUDA
    is initialised in this process. The host side of the calling thread,
    or with ``every_thread`` of every thread. The raw primitive: no gating,
    no lock; callers that may race a window capture use
    :func:`dispatch_trace`."""
    import torch

    from .trace import labelling_every_thread

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"ka_{what}_{os.getpid()}_{next(_SEQ)}.json")
    config = (torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
              if every_thread else None)
    prof = torch.profiler.profile(activities=activities, experimental_config=config)
    prof.start()
    try:
        with labelling_every_thread() if every_thread else contextlib.nullcontext():
            yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def dispatch_trace() -> Iterator[None]:
    """The per-solve-dispatch hook: trace the block into the configured
    profile directory, labelled :data:`DISPATCH_LABEL`, when one is set;
    otherwise (or when a window capture holds the profiler) yield
    untraced."""
    log_dir = profile_dir()
    if not log_dir:
        yield
        return
    if not _PROFILER_LOCK.acquire(blocking=False):
        yield
        return
    try:
        import torch

        with device_trace(log_dir, "dispatch"):
            with torch.profiler.record_function(DISPATCH_LABEL):
                yield
    finally:
        _PROFILER_LOCK.release()


def capture_window(seconds: float,
                   out_dir: Optional[str] = None) -> str:
    """Capture one bounded trace window into the profile directory and
    return the directory. Raises ``RuntimeError`` when profiling is
    disabled (no directory configured), :class:`ProfilerBusy` when another
    capture holds the profiler, and ``ValueError`` on a nonsensical
    window."""
    import time

    log_dir = out_dir or profile_dir()
    if not log_dir:
        raise RuntimeError(
            "device profiling is disabled: set KA_OBS_PROFILE_DIR to a "
            "trace output directory"
        )
    seconds = float(seconds)
    if not (seconds == seconds and seconds > 0):  # NaN-safe positivity
        raise ValueError(f"seconds must be positive, got {seconds!r}")
    seconds = min(max(seconds, MIN_WINDOW_S), MAX_WINDOW_S)
    if not _PROFILER_LOCK.acquire(blocking=False):
        raise ProfilerBusy(
            "a profiler capture is already in progress; retry when it ends"
        )
    try:
        with device_trace(log_dir, "window", every_thread=True):
            time.sleep(seconds)
    finally:
        _PROFILER_LOCK.release()
    return log_dir
