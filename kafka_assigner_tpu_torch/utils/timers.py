"""DEPRECATED compat shim over ``obs/``, the port of the reference's
``kafka_assigner_tpu/utils/timers.py``: ``Timers`` keeps its contract (a
live ``.ms`` dict accumulating per-phase wall milliseconds, obs enabled or
not), and ``device_trace`` is re-exported from ``obs/profile.py``. New code
uses ``obs`` directly::

    from kafka_assigner_tpu_torch.obs import span
    with span("encode"):
        ...
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

from ..obs.profile import device_trace  # noqa: F401  (compat re-export)
from ..obs.trace import span
from .logging import get_logger

_log = get_logger("timers")


class Timers:
    """Deprecated: a bag of named phase timers backed by obs spans.

    ``.ms`` accumulates per-phase wall milliseconds; when an obs run
    capture is active each phase also records a span."""

    def __init__(self) -> None:
        self.ms: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        with span(name, sink=self.ms, key=name, log=_log):
            yield

    def report(self) -> Dict[str, float]:
        return dict(self.ms)
